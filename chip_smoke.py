#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mpi4jax_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. build: the hand-written kernels are compiled from
   ``mpi4jax_tpu_torch/kernels/csrc/*.cu`` with nvcc for sm_90a, one
   nvcc per source, all started together; nvcc's seconds per source and
   ptxas's registers and spills per kernel and head dim are printed.
2. kernels (shallow water): at the published 3600x1800 domain (ghost 2,
   one rank) each kernel is held bit for bit against its plain PyTorch
   version on the same inputs on the card, sw_main for both first-step
   values there and on three small blocks of random fields
   (``SW_CHECK_CASES``: both walls; each wall alone on a second rank's
   block, iy = 1), and timed beside its bound, its plain version and
   the measured device-to-device copy rate; one sw_main launch captured
   in a CUDA graph and replayed must equal the eager launch bit for
   bit.
3. path (shallow water): the solver's main path, ``make_solver`` on the
   benchmark configuration for 0.1 model days, runs through the entry
   points with every kernel launch count set to 0 just before and read
   just after.  Its chunks are CUDA graphs (``make_multistep``): the
   warm-up chunk runs eagerly, the rest are replays, so for both step
   kernels the eager launches plus replays times the launches captured
   per chunk must equal the steps.  The result must be finite and
   conserve mass, and 25 steps on the kernel path must agree with 25
   steps on the plain path from the same state.
4. profile (shallow water): one replay of a 25-step chunk's graph under
   torch.profiler: 25 device launches of each kernel, the device time
   per step by kernel and the device's idle share under the graph.
4b. schedules (shallow water): ghost 1, 2 and 4 at 3600x1800, 25 steps
   each through ``make_multistep``: the graph replay equal to the eager
   chunk bit for bit, the three schedules' h within 1e-3 of each other,
   ghost 4 conserving mass, each schedule's ms per step under the graph
   and its device time and idle share in one traced replay; bfloat16 at
   ghost 1 and 4 finite after a replay, and ghost 2 in bfloat16 refused
   on the card with the error that names ghost 1 and 4.
4b'. multi-rank (shallow water): a 2x2 grid of ranks on the one card,
   four threads of this process over gloo (``local_world``), CUDA
   tensors staged through host memory.  Every ported op (allreduce with
   all ten operators, scan, allgather, sendrecv on a ring and on
   ``shift_perm``, send/recv with ANY_TAG and with ANY_SOURCE, barrier,
   split, sub; alltoall, alltoall_multi, reduce_scatter, bcast, gather,
   reduce and scatter in float32, int32 and bool on the world comm, the
   rooted ones at roots 0 and 3, and on ``sub("x")``; the backward of
   eight ops and one forward-mode case) on CUDA tensors against the
   same op on the CPU (``--check ops`` runs these alone); then, on
   each rank's own 904x1804 block (ghost ring included) with its own
   wall (south on the first row of ranks, north on the second) and at
   the inputs the decomposed step gives it, sw_main for both first-step
   values and sw_visc held bit for bit to their plain versions; then the
   full 3600x1800 domain in 1800x900 blocks at ghost 2 for 10 steps through
   ``make_solver`` (gloo chunks run eagerly), every launch count set to
   0 just before and read just after: sw_main and sw_visc 4 times a
   step; the gathered h within 2e-4 of the one-rank kernel run from the
   same initial state (the mean's sum order differs, so not bit for
   bit), mass within rtol 1e-5; ms a step printed as a reading.
4c. bench: ``mpi4jax_tpu_torch.bench.run_bench(quick=True)`` in this
   process; its JSON record is printed on a line of its own.
5. kernels (flash forward): both forward kernels against their plain
   version (at each kernel's own key tile) on the card, with the row
   statistics m and l: the bf16 kernel at the decode path's prefill
   shape [4, 8192, 8, 64] and the training path's [2, 8192, 16, 128],
   causal, and at [2, 2048, 16, 128]; the f32 (3xTF32) kernel at the
   training path's shape; both kernels (f32 and bf16) on a padded case,
   q/k offsets with and without fully masked rows, grouped-query heads
   and D 128 with offsets; the bf16 kernel at the MFU preset's shape
   [16, 2048, 16, 128]: the largest and the mean output difference
   and the largest m and l difference, each within a limit that planted
   faults exceed; every case is checked before the phase raises.  The
   bf16 kernel is timed at both path shapes and the MFU preset's, the
   f32 kernel at the f32 decode check's prefill shape [2, 1024, 8, 64]
   and at the training path's shape, each beside its bound, its plain
   version and one scaled_dot_product_attention call (with the kernels
   that call ran, from a profiler trace).
6. path (decode): the long-prompt serving point (batch 4, prompt 8192,
   256 generated tokens, bf16, flash prefill, kv_bucket 16) through
   ``make_global_decode``, every launch count set to 0 just before each
   call and read just after: the prefill launches the bf16 flash kernel
   once per layer and the f32 one never; the first call runs eagerly and
   captures one CUDA graph of the generate step per cache view length
   (16), every later call captures none and replays them 255 times.
   Tokens are [4, 8448] with the prompt echoed, and the graph decode
   equals the eager decoder (``_greedy_decode``, same flash prefill) by
   ``torch.equal``: on these prompts, on other prompts, and with other
   parameter tensors (captured anew); a categorical decode (top_k 50,
   temperature 0.8, a fixed key) equals its eager run too, and the
   threefry bits of its first draw on the card equal the CPU's.  On a
   difference the first differing position and the eager logits there
   are printed.  Prefill ms, ms per generated token, generated tokens/s
   and the bytes bound are printed.  The kernel prefill's last-position
   logits are held against a prefill on the plain flash version, and in
   f32 (prompt 1024, batch 2, max_len 1152) the graphs, the eager
   decoder (one launch of the f32 flash kernel per layer) and the plain
   path give identical tokens.
7. profile (decode): one decode call under torch.profiler, for device
   time by kernel in the prefill and the generation loop, the loop's
   device time and launches per replayed step, and its idle share
   against the untraced loop and against its traced timeline.
7b. short-prompt decode: the bench's two batch-16 legs
   (``bench.DECODE_LEGS``: prompt 16, max_len 512, bf16, without and
   with kv_bucket 16) through ``run_decode(batches=1)``, generated
   tokens/s.
8. kernels (flash backward): the backward kernels (dkv, dq) of each
   dtype against their plain versions (at the kernel's own key tile) on
   the same inputs and the same forward (out, m, l): both pairs at the
   training path's shape [2, 8192, 16, 128] causal, and both pairs (f32
   and bf16) on a padded case, q/k offsets, fully masked rows,
   grouped-query heads and D 32, the bf16 pair at D 64 and at the MFU
   preset's shape [16, 2048, 16, 128] too, each case on its own seed and
   three more; for each of dq, dk and dv the mean
   absolute difference over max|plain| and the largest (f32: over
   max|plain|; bf16: in bf16 steps of max|plain|), each within a limit
   that planted faults exceed; every case is checked before the phase
   raises.  The bf16 pair is timed at
   the path shape and the MFU preset's, the f32 pair at the f32 decode
   check's shape [2, 1024, 8, 64] causal and at the path shape, each beside its bound, its
   plain version and the backward of one scaled_dot_product_attention
   call (with the kernels its forward and backward ran, from a
   profiler trace).
9. path (train): the long-context training preset as written (~940M
   parameters, batch 2, seq 8192, bf16, flash attention, remat="names";
   benchmarks/transformer.py SIZES["long"]) through
   ``make_global_train_step``: one warm-up step, then timed steps with
   every launch count set to 0 just before each and read just after it:
   per step 32 launches of flash_fwd_mma (the forward and the backward's
   recompute of each layer) and 16 of each bf16 backward kernel
   (flash_bwd_dkv_mma, flash_bwd_dq_mma), none of the f32 ones.  Losses
   finite, parameters changed; step ms, tokens/s, both MFU readings and
   the peak memory are printed beside the card's name and power limit.
   Then at 2 layers of the same width and sequence the bf16 gradient of
   the loss on the kernel path is held against the gradient on the
   plain path (the kernels' plain versions as the attention function),
   leaf by leaf; and likewise in f32 at the decode model's width (batch
   2, seq 1024), where the f32 kernels launch once per layer each.  The
   bf16 check runs on seed 1 and three more and also reads each path
   against a float64 witness of the gradient (the same loss from the
   same bf16 inputs in float64): per leaf the kernel path's mean
   difference from it within ``TRAIN_WITNESS_RATIO`` of the plain
   path's, which sees a forward fault the largest difference cannot.
   Each remat policy (``REMAT_POLICIES``: True, "dots", "names", two
   save-lists) runs the kernel path too, on the same seeds: its loss
   and every leaf equal bit for bit to the kernel path without remat,
   and within ``TRAIN_WITNESS_RATIO`` of the plain path against the
   witness, its launches 2 of flash_fwd_mma and 1 of each backward
   kernel a layer.
10. profile (train): one step under torch.profiler, for device time by
   kernel, the flash kernels' share of it and the idle share.
10b. the bench's training legs (``bench.training_legs``): the small
   preset's tokens/s, the bf16 matmul yardstick, the MFU preset
   ("large", remat="names", the autotuned attention) and the long
   preset, each once at 1 timed batch and 1 yardstick burst: every
   leg's code on the card; the timed sizes are the bench's.  Every
   launch count is set to 0 just before each leg's timed batch and read
   just after it: per step and layer, the small preset (no remat) 1 of
   each bf16 flash kernel, the large and long presets
   (``TRAIN_LAUNCHES``) 2 of flash_fwd_mma and 1 of each bf16 backward
   kernel, none of the f32 ones; the large leg's autotuned attention
   must be the flash kernels.
10c. multi-rank transformer: four thread ranks of a local world on the
   card (gloo) on the JAX bench's 4-device meshes.  Training on (dp, tp,
   sp) = (1, 2, 2) at the long preset's width cut to 2 layers, batch 2,
   seq 2048 a sp rank, remat="names", for the ring, the zigzag ring
   (the step's ring attention given the zigzag layout and the batch
   reordered to it) and Ulysses (flash): in f32 one step at lr 1 held
   to the one-rank step on the same global batch (dense attention),
   the loss and every leaf gathered with ``gather_params`` within
   ``MESH_TRAIN_LIMIT``, and a planted fault (a gradient sync that
   skips sp) read beside them, which must fail it; then one bf16 step
   per scheme with every launch count set to 0 just before and read
   just after: Ulysses 2 x layers flash_fwd_mma and layers of each bf16
   backward kernel a rank, the ring none.  The decoder on (dp, tp) =
   (2, 2) at the decode model's width in f32, greedy, prompt 16 of 48
   positions, its steps eager (gloo): every rank's tokens equal to the
   one-rank decoder's.  Phases 5 and 8 hold the flash kernels at the
   shapes this path gives them: Ulysses at the long leg on (1, 2, 2)
   [2, 16384, 4, 128] bf16 causal (forward and backward) and the
   decode prefill at tp 2 [4, 8192, 4, 64] (forward), and time them
   there beside scaled_dot_product_attention (``mesh_shape_timings``,
   also under ``--check fwd,bwd``).
11. proc tier: the native bridge (g++ of ``dcn.cc``, ``shm.cc`` and the
   port's C shim, built beside the kernels in phase 1, its seconds
   printed) and launcher jobs of the port
   (``python -m mpi4jax_tpu_torch.launch -np 4``, every rank on the one
   card, this script as the program under ``--proc-rank``): (a) the
   proc battery (``proc_battery``: every op with several operators and
   dtypes, user operators, rank-dependent gather/scatter, tagged
   send/recv with Status, sendrecv, sendrecv_multi and alltoall_multi
   fused and unfused, the gradients of allreduce SUM and sendrecv) on
   CUDA tensors staged through pinned host memory, equal bit for bit to
   the same battery on CPU tensors in a second job; (b) the 2x2 halo
   exchange of h, u and v at the flagship's per-rank block (1804x904
   f32, ghost 2) on a ProcGridComm, fused and unfused, equal bit for bit
   to each other and to the same exchange in a local world of four gloo
   thread ranks; (c) a planted failure: the launcher exits nonzero
   within its deadline and names the failing rank first; (d) the
   bench's two proc legs at ``--quick`` sizes (``bench.proc_legs``: the
   8-rank allreduce busbw at 4 MB and 4 reps, staged and on host
   memory, and the 8-rank halo latency, coalescing on and off); (e) the
   nonblocking requests (``proc_async``, ``--proc-rank async``: the JAX
   package's async matrix of iallreduce SUM and MAX at 1, 997 and 65537
   elements waited out of order, six requests under waitall, an
   isend/irecv ring, ireduce_scatter, test then wait, the double wait,
   a dropped operand; ``make_dp_train_step`` on ``StackParams`` (4
   layers, width 64) and ``MLPParams`` for 3 steps with overlap on and
   off; error feedback at the bf16 wire dtype) with every request on
   CUDA tensors, each result equal to its blocking op bit for bit and
   the two arms of the dp step to each other, and the whole job equal to
   the same job on CPU tensors: bit for bit but for the dp step's
   parameters and losses, within ``DP_CARD_RTOL`` (float32 products
   summed in another order on the card); (f) the bench's overlap leg
   (``bench.overlap_leg``) with one timed batch: its six keys.  Each
   job's seconds and the legs' numbers are printed.
12. MLP steps across ranks: ``models/train.py``'s
   ``make_global_train_step`` and ``make_global_zero_train_step``
   (momentum 0.9) for 3 steps each on a (dp, tp) = (2, 2) local world of
   gloo thread ranks on the card, every rank's parameter shards, momentum
   chunks and losses within ``DP_CARD_RTOL`` of the same world on the
   CPU, the losses falling; both worlds' seconds are printed.
13. MoE transformer (``models/moe_transformer.py``, ``parallel/moe.py``):
   (a) the bench's moe mode's model (``MOE_CFG``: vocab 32768, d_model
   512, 8 layers, 8 heads of 64, d_ff 2048, 4 experts) at batch 8, seq
   1024 on one card through ``make_global_train_step``, in f32 then
   bf16: one warm-up step, then ``MOE_TIMED_STEPS`` timed steps with
   every launch count set to 0 just before each and read just after:
   per step and layer one launch of each flash kernel of the route
   ``flash_supported`` picks for the attention's operands (printed; the
   phase fails if it picks none), the losses finite, the returned
   parameters changed and the step's inputs unchanged; step ms,
   tokens/s, model TFLOP/s on the active parameters and the peak memory
   beside the card's name and power limit, and one more step under
   torch.profiler: device ms by kernel class and the idle share.  (b) at 2 layers in f32, one
   step at lr 1 on the kernel path, on the plain path (the flash kernels'
   plain versions as the attention function) and on ``reference_loss``'s
   gradient: each pair's routes equal, its loss and every updated leaf
   within ``MOE_CHECK_LIMIT``.  (c) four gloo thread ranks on the card on
   (dp, tp, sp) = (1, 2, 2) with 8 experts, 2 layers, both routings: one
   f32 step at lr 1, gathered, against the one-rank ``reference_loss``
   step on the same global batch, and a planted fault (a gradient sync
   that sums the expert leaves over sp) that must fail it; then
   ``topk_moe`` with 2 experts a rank (``alltoall_multi``) on CUDA
   tensors against the same world on CPU tensors.  (d) the bench's moe
   mode itself (``transformer_train.run(mode="moe")``) on the model of
   (a), f32 then bf16, at one timed batch: every launch count set to 0
   just before the timed batch and read just after, each flash kernel of
   (a)'s route once a layer a timed step, and its record's numbers
   positive and finite.
14. pipeline (``models/pipeline.py``, ``models/pp_transformer.py``): (a)
   the bench's pp mode (``transformer_train.run(mode="pp")``) at its
   defaults (``PP_CFG``: the dense model of the moe model's width, 8
   layers; batch 8, seq 1024, 4 microbatches, GPipe, one stage on one
   card) in f32 then bf16, one timed batch, every launch count set to 0
   just before it and read just after: no flash launch (the stage's
   attention is the dense path, as in JAX); step ms, tokens/s and the
   peak memory, the record the pp mode's, and one more step under
   torch.profiler (device ms by kernel class).  (b) four gloo thread
   ranks on the card on (dp, pp) = (1, 4), 2 layers a stage, f32: one
   step of each schedule at lr 1, gathered, against the one-rank dense
   step on the same batch within ``MESH_TRAIN_LIMIT``, every rank's
   exchanges (``M + S - 1`` handoffs and as many transposes for GPipe,
   ``2(M + 2(S - 1))`` for 1F1B) and the same bits of ``embed``,
   ``ln_f`` and ``head`` on every rank; a planted fault (the replicated
   leaves not summed over pp) must exceed the limit.  (c) the one-card
   step in bf16 at 8 microbatches: each schedule's peak memory from
   ``max_memory_allocated``, 1F1B's below GPipe's.
15. serving (``serving/engine.py``): (a) the continuous-batching engine
   on a ``SelfComm`` on the card, the decode benchmark's model at its
   published width (``SERVE_CFG``: vocab 32768, d_model 512, 8 layers, 8
   heads and 8 KV heads of 64, d_ff 2048) in f32 with TF32 off, seeded
   parameters, ``max_batch`` 8, ``max_len`` 512, admission off: every
   prefill bucket warmed, then 24 ``LoadGen`` requests (prompts 16-256,
   ``max_new`` 8-96) offered at t = 0 and drained, every launch count
   set to 0 just before and read just after: no flash launch (the
   engine's attention is the dense path, as in JAX); the request
   accounting; every response held to ``reference_greedy_decode`` on the
   card, a departure accepted only where the oracle's top two logits lie
   within ``SERVE_TIE_LIMIT``; wall, tokens/s, steps, mean occupancy,
   p50/p99 latency and time to first token, the slot step's ms (CUDA
   events) and each bucket's prefill ms; then an open-loop window
   (admission on, 2000 ms SLO, 3 s at 80 requests/s), its accounting
   held, its shed count and SLO attainment reported.  (b) a planted
   fault (every row of the slot step attends at slot 0's position) must
   fail (a)'s check at a gap of at least ten times the limit.  (c) a
   ``--serve`` launcher job of 2 ranks on the card (tp 2, CUDA tensors
   staged through host memory, 8 requests with prompts up to 64): the
   ranks' finished lists equal, held to the oracle as in (a).  (d) the
   bench's serving leg (``bench.serving_leg``, an 8-rank job): its seven
   keys finite.
16. fault tolerance (``utils/checkpoint.py``, the launcher's
   ``--restarts`` and ``--elastic``, ``models/train.py:run_elastic``):
   (a) the flagship at 3600x1800, ghost 2, in chunks of
   ``ELASTIC_SW_CHUNK`` steps: run A goes to ``t_full`` uninterrupted;
   run B, checkpointed every chunk, stops at ``t_half`` (2 timed chunks),
   and a fresh ``make_solver`` in the same directory resumes it to
   ``t_full`` with every launch count set to 0 just before and read just
   after (the slice's main path): sw_main and sw_visc once a step (eager
   launches plus replays times the captured ones), and all six fields
   equal to run A's by ``torch.equal``; one chunk's save timed
   (``SAVE_REPEATS``, the median) and the checkpoint's bytes printed.
   (b) ``proc_recover``'s job (the contract of
   tests/proc/test_failure_recovery.py on CUDA tensors, ``RECOVER``) of 2
   ranks on the card under ``--restarts 1``: rank 1 exits hard after
   step 7 (the step-5 checkpoint committed) in the first attempt only,
   the launcher relaunches the job, which resumes from step 5; its final
   state equals an uninterrupted job's bit for bit.  (c)
   ``run_elastic`` at the bench overlap leg's width (``ELASTIC_RUN``: d
   1024, 6 layers, batch 16) on 4 ranks on the card under ``--elastic
   rejoin``: rank 2 exits hard once the step-4 checkpoint is committed on
   every rank, in its first incarnation only; the job exits 0 with every
   slot in the final world, the survivors through at least 2 resizes,
   every rank's final world 4 and its final parameters equal to rank 0's
   bit for bit; the job's seconds and the time from the death to the
   rejoined world's first step are printed.  Each kernel's entry gains
   ``launches_elastic``.

Prints, last, a ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 before printing any result.

    python3 chip_smoke.py --fault-readings

builds and runs the checks of phases 2, 5 and 8 (not their timings)
and the 2-layer training gradients on this tree and, at the same time,
on throw-away copies of it each with one fault planted (``FAULT_PLANS``)
in ``sw_step.cu`` (``SW_FAULTS``: the sw_main checks), in
``flash_fwd_mma.cu`` (``FLASH_FAULTS``: the forward checks, and for
the dropped diagonal tile the gradients too), in ``flash_fwd.cu``
(``F32_FLASH_FAULTS``: the forward checks), in ``flash_bwd.cu``
(``BWD_FAULTS``) or in ``flash_bwd_mma.cu`` (``BWD_MMA_FAULTS``, and
``BWD_MMA_READINGS``, read but not judged: the backward checks), and
prints every copy's readings: the evidence for the limits.  It exits 0
when the sound tree passes, every fault fails and the dropped diagonal
tile fails the gradient check too.

    python3 chip_smoke.py --check fwd,bwd,grad,sw,ops,mesh,proc,mlp,moe,pp,serve,elastic [--no-timings]

runs those checks (any of them) on this tree alone (``proc``: phase 11,
``mlp``: phase 12, ``moe``: phase 13, ``pp``: phase 14, ``serve``:
phase 15, ``elastic``: phase 16);
``fwd`` and ``bwd`` also time the bf16 kernels at the meshes' shapes
unless ``--no-timings`` is given (``--fault-readings`` gives it to its
copies, which share the card and so could time nothing).

    python -m mpi4jax_tpu_torch.launch -np N chip_smoke.py --proc-rank \
        battery OUT_DIR [NY NX]

is a rank of phase 11's jobs (``async OUT_DIR`` the requests of (e),
``fail -`` the planted failure): the results go to
``OUT_DIR/rank<r>.npz``.  ``serve OUT_DIR`` (under ``--serve``) is a rank
of phase 15 (c)'s job; its finished list goes to
``OUT_DIR/rank<r>.json``.  ``recover OUT_DIR TOTAL KILL_RANK KILL_STEP``
and ``elastic OUT_DIR STEPS D LAYERS BATCH SAVE_EVERY KILL_RANK
KILL_STEP`` (under ``--elastic rejoin``) are the ranks of phase 16 (b)
and (c); tests/test_torch_elastic.py runs them on the CPU.

    python3 chip_smoke.py --sw-forms other/sw_step.cu [...]

builds each ``sw_step.cu`` named (an earlier commit's, or an edited
copy: another form of sw_main), holds its sw_main to the plain version
bit for bit and times it in turns with the tree's own at the bench
shape.

    python3 chip_smoke.py --nccl-world 4

on a host with four cards: four processes, one per card, join an NCCL
world (torchrun's environment on a free local port) and run the 2x2
op cases and the solver check of phase 4b': every op case on CUDA
tensors over NCCL (send/recv over the world's gloo twin groups; the
backward cases on autograd's device thread) against the same cases run
beforehand in a CPU local world, then BASELINE.json configs 3 and 4 at
their size (1024x1024 float32: bcast, scatter and gather from rank 0;
alltoall over the world, its rows and its columns), held to a CPU local
world bit for bit, each op's device ms by CUDA events and bus GB/s,
then the solver with ``make_multistep`` as a CUDA graph that holds the
NCCL exchanges (each rank first runs the one-rank reference on its
card), then the 64 MB allreduce's bus bandwidth,
``allreduce_busbw_gbps`` with ``allreduce_devices``, then the bench
across the world (``bench.run_bench(quick=True)`` on the 2x2 grid of the
four cards): every rank must take the same schedule and return the same
record, rank 0's finite with ``allreduce_devices`` 4; then the
transformer: the decoder on (dp, tp) = (2, 2) in f32 with its generate
steps CUDA graphs that hold the NCCL allreduces, its tokens equal to a
(2, 2) gloo world's on the same card (run before NCCL starts), and the
bench's three decode legs on the mesh (bf16, one timed burst); the long
training preset as written (16 layers, batch 2, seq 8192 a sp rank,
bf16, remat="names") on (dp, tp, sp) = (1, 2, 2) through
``transformer_train.preset_run`` for the ring and for Ulysses: step ms
(the slowest rank's), tokens/s in all and a card, each rank's peak
memory; and one step of each traced on rank 0 (device ms by kernel
class: flash, cuBLAS GEMMs, NCCL, the rest); then the bench's pp mode
(``PP_CFG``, GPipe, 4 microbatches) on (dp, pp) = (1, 4) in f32 and
bf16: every rank must return the same record (step ms, tokens/s in all
and a card, each rank's peak memory), and one f32 step traced on rank
0.  Each rank ends its world with ``distributed.finalize()``.  It
raises with fewer than four cards.

    python3 chip_smoke.py --nccl-world 4 pp

runs the bench's pp mode across the four cards alone (no kernel is
built: none runs on that path).

    python3 chip_smoke.py --witness-readings

reads the bf16 backward kernels and their plain versions against a
float64 witness, the exact gradient from the same bf16 inputs, on eight
seeds of four cases (``WITNESS_CASES``): the evidence for the bf16
limits' measure.
"""

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mpi4jax_tpu_torch import bench as port_bench
from mpi4jax_tpu_torch import serving
from mpi4jax_tpu_torch import launch
from mpi4jax_tpu_torch import ops as p_ops
from mpi4jax_tpu_torch.benchmarks import serving as serving_bench
from mpi4jax_tpu_torch.examples import transformer_decode, transformer_train
from mpi4jax_tpu_torch.kernels import _build, sw_step
from mpi4jax_tpu_torch.kernels import flash as kflash
from mpi4jax_tpu_torch.kernels import flash_bwd as kbwd
from mpi4jax_tpu_torch.models import moe_transformer as moe
from mpi4jax_tpu_torch.models import pp_transformer as ppt
from mpi4jax_tpu_torch.models import shallow_water as sw
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.native import build as native_build
from mpi4jax_tpu_torch.ops import p2p as p_p2p
from mpi4jax_tpu_torch.parallel import distributed
from mpi4jax_tpu_torch.parallel import moe as pmoe
from mpi4jax_tpu_torch.parallel.comm import MeshComm, SelfComm
from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d
from mpi4jax_tpu_torch.parallel.longseq import zigzag_shard
from mpi4jax_tpu_torch.serving import engine as serving_engine
from mpi4jax_tpu_torch.utils import prng
from mpi4jax_tpu_torch.utils.runtime import graph_capture

SOURCES = ("sw_step", "flash_fwd", "flash_fwd_mma", "flash_bwd",
           "flash_bwd_mma")
# the flash kernels' sources, built by the checks alone
FLASH_SOURCES = SOURCES[1:]

# H100 SXM data-sheet peaks (dense): device memory, float32 outside the
# tensor cores, TF32 and bf16 in them.  The shallow-water kernels do
# float32 arithmetic on CUDA cores.  Attention's bound in bf16 is the
# bf16 tensor-core rate; in f32 it is the least time for f32-class
# products: the lesser of the operations over the CUDA cores' f32 rate
# and three times the operations (3xTF32: three TF32 products per f32
# product) over the TF32 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_TF32_PER_S = 494.7e12
PEAK_BF16_PER_S = 989e12

# float operations per interior cell, counted once per intermediate
# (the kernel recomputes some of them per thread; that is not work the
# function needs).  sw_main: fe 3, fn 3, q 16, ke 10, dh 6, du 15,
# dv 15, plus the AB2 update of h, u, v (5 each).  sw_visc: per field
# 3 + 3 for the two viscous fluxes, 5 for their divergence, 2 for the
# update.
FLOPS_PER_CELL = {"sw_main": 83, "sw_visc": 26}

KERNEL_TOL = {"state": 1e-6, "tendency": 1e-4}
PATH_TOL = 2e-4
MASS_RTOL = 1e-5
TIMED_LAUNCHES = 25

# the multi-rank phases: a 2x2 grid of ranks on the full domain (1800x900
# blocks at ghost 2), MULTIRANK_STEPS steps through make_solver in chunks
# of MULTIRANK_CHUNK (the bootstrap step, the warm-up chunk, two timed
# chunks); the ops' float sums against the CPU within
# MULTIRANK_FLOAT_TOL of the largest value (the CPU tests' tolerance)
MULTIRANK_GRID = (2, 2)
MULTIRANK_STEPS = 10
MULTIRANK_CHUNK = 3
MULTIRANK_OPS = ("sum", "prod", "min", "max", "land", "lor", "lxor",
                 "band", "bor", "bxor")
MULTIRANK_FLOAT_TOL = 4e-6
NCCL_RANK_TIMEOUT_S = 720.0  # an --nccl-world rank's whole run
FINALIZE_TIMEOUT_S = 60.0  # distributed.finalize on an --nccl-world rank
# BASELINE.json configs 3 and 4 over --nccl-world: 1024x1024 float32 per
# rank, each op's device time the median of BASELINE_REPEATS calls
# the proc tier's phase: launcher jobs of PROC_RANKS ranks on the one
# card; the 2x2 halo at the flagship's per-rank block (3600x1800 over
# 2x2, ghost 2 on each side) for h, u and v
PROC_RANKS = 4
PROC_FIELDS = ("h", "u", "v")
PROC_GHOST = 2
PROC_HALO_BLOCK = (1800 + 2 * PROC_GHOST, 900 + 2 * PROC_GHOST)
PROC_JOB_TIMEOUT_S = 240.0
PROC_FAIL_TIMEOUT_S = 90.0
# phase 11 (e): make_dp_train_step's StackParams (layers, width) and
# steps, and the error-feedback steps
DP_LAYERS, DP_WIDTH = 4, 64
DP_STEPS = 3
EF_STEPS = 2
# the dp step's, and phase 12's, card-vs-CPU limit: float32 products
# summed in another order on the card
DP_CARD_RTOL = 1e-5
# phase 12: the (dp, tp) mesh, (d_in, hidden, d_out, global batch), the
# steps of each MLP step and their rate
MLP_MESH = (2, 2)
MLP_SIZES = (64, 256, 16, 32)
MLP_STEPS = 3
MLP_LR = 5e-2
# phase 13: the model of the bench's moe mode (benchmarks/transformer.py
# run's defaults, 4 experts a sp rank; transformer_train.run(mode="moe"))
# at batch 8, seq 1024 on one card, its SGD rate and timed steps
MOE_CFG = moe.MoEConfig(vocab=32768, d_model=512, layers=8, heads=8,
                        kv_heads=8, head_dim=64, experts=4, d_ff=2048)
MOE_RUN = dict(batch=8, seq=1024)
# its attention's shape (B, Tq, Tk, Hq, Hkv, D): one more case of the
# flash kernels' checks, in bf16 and f32 (the bench's small preset
# gives the dense model the same shape)
MOE_SHAPE = (MOE_RUN["batch"], MOE_RUN["seq"], MOE_RUN["seq"],
             MOE_CFG.heads, MOE_CFG.kv_heads, MOE_CFG.head_dim)
MOE_LR = 1e-3
MOE_TIMED_STEPS = 3
# (b): the kernel path, the plain path and reference_loss's gradient at 2
# layers in f32, one step at lr 1 (the update is the gradient): the
# loss's relative difference and per leaf max|difference| over
# max|update|, each pair within this limit (MESH_TRAIN_LIMIT's measure
# and value; the f32 kernels differ from their plain versions by about
# 1e-6 of the largest value, F32_GRAD_LIMIT)
MOE_CHECK_LAYERS = 2
MOE_CHECK_LR = 1.0
MOE_CHECK_LIMIT = 1e-3
# (c): four thread ranks on the JAX bench's mesh (1, 2, 2), 8 experts (4
# a sp rank, as the bench's moe mode), 2 layers, batch 2, seq 1024 a sp
# rank; and topk_moe on a 1-D world of 4 ranks, 2 experts a rank
MOE_MESH = (1, 2, 2)
MOE_MESH_CFG = MOE_CFG._replace(layers=2, experts=8)
MOE_MESH_BATCH, MOE_MESH_SEQ = 2, 1024
MOE_A2A = dict(ranks=4, experts=8, k=2, tokens=1024, d_model=512)
# phase 14: the bench's pp mode (benchmarks/transformer.py run's
# defaults: the dense model of MOE_CFG's width, 8 layers, batch 8, seq
# 1024, 4 microbatches, GPipe); its stages attend on the dense path
PP_CFG = tfm.TransformerConfig(vocab=32768, d_model=512, layers=8, heads=8,
                               kv_heads=8, head_dim=64, d_ff=2048,
                               attn_impl="xla")
PP_RUN = dict(batch=8, seq=1024, micro=4)
# (b): four gloo thread ranks on the JAX bench's (dp, pp) mesh, 2 layers
# a stage, f32, one step at MESH_CHECK_LR of each schedule against the
# one-rank dense step, within MESH_TRAIN_LIMIT (mesh_readings)
PP_MESH = (1, 4)
# (c): GPipe against 1F1B in memory, one card, bf16, one sequence a
# microbatch
PP_MEMORY_MICRO = 8
# phase 15: the serving engine on the decode benchmark's model at its
# published width (benchmarks/transformer.py run_decode's defaults), f32
# with TF32 off; (a) 24 LoadGen requests on one card, offered at t = 0
SERVE_CFG = tfm.TransformerConfig(
    vocab=port_bench.DECODE_MODEL["vocab"],
    d_model=port_bench.DECODE_MODEL["d_model"],
    layers=port_bench.DECODE_MODEL["layers"],
    heads=port_bench.DECODE_MODEL["heads"],
    kv_heads=port_bench.DECODE_MODEL["kv_heads"],
    head_dim=port_bench.DECODE_MODEL["d_model"]
    // port_bench.DECODE_MODEL["heads"],
    d_ff=port_bench.DECODE_MODEL["d_ff"],
)
SERVE_RUN = dict(max_batch=8, max_len=port_bench.DECODE_MODEL["max_len"],
                 requests=24, prompt=(16, 256), new=(8, 96), seed=2026)
# a response may depart from reference_greedy_decode only where the
# oracle's top two logits lie closer than this (f32 products of two
# cuBLAS call shapes differ by ~1e-5 of logits of size ~1; the planted
# fault of (b) departs at gaps of ~1e-1)
SERVE_TIE_LIMIT = 1e-3
# (a)'s open-loop window: admission on, arrivals that overload 8 slots
SERVE_OPEN = dict(slo_ms=2000.0, seconds=3.0, rate=80.0, seed=7)
# (c): a --serve launcher job of 2 ranks on the card, tp 2
SERVE_PROC = dict(ranks=2, max_batch=4, max_len=128, requests=8,
                  prompt=(4, 64), new=(8, 32), seed=11)
SERVE_PROC_TIMEOUT_S = 300.0
# phase 16: (a) the flagship at its bench size and ghost 2, checkpointed
# every chunk of ELASTIC_SW_CHUNK steps: run B stops after 2 timed
# chunks, and its resume runs 2 more; SAVE_REPEATS timed saves of the
# state
ELASTIC_SW_CHUNK = 10
SAVE_REPEATS = 3
# (b): the failure-recovery contract of tests/proc/test_failure_recovery
# .py on a --restarts 1 job: 10 steps, rank 0 saving every 5, rank 1
# exiting hard after step 7 in the first attempt
RECOVER = dict(ranks=2, total=10, kill_rank=1, kill_step=7)
# (c): run_elastic at the bench overlap leg's width on 4 ranks under
# --elastic rejoin, rank 2 exiting hard once the step-4 checkpoint is
# committed everywhere, in its first incarnation
ELASTIC_RUN = dict(ranks=4, steps=12, d=port_bench.OVERLAP["d_model"],
                   layers=port_bench.OVERLAP["layers"],
                   batch=port_bench.OVERLAP["batch"], save_every=2,
                   kill_rank=2, kill_step=4)
# the elastic jobs' bridge knobs (the JAX package's elastic tests')
ELASTIC_ENV = dict(T4J_MIN_WORLD="2", T4J_RESIZE_TIMEOUT="15",
                   T4J_CONNECT_TIMEOUT="10", T4J_RETRY_MAX="2",
                   T4J_BACKOFF_BASE="0.05", T4J_BACKOFF_MAX="0.3")
ELASTIC_TIMEOUT_S = 300.0

BASELINE_SIDE = 1024
BASELINE_REPEATS = 10

# flash kernel against its plain version at the same key tile.  The two
# differ only where the summation order moves a score across a rounding
# boundary: in f32 by a few ulps; in bf16 where a weight's exponential or
# an output rounds to the other bf16 neighbour, which is rare but may
# move one output element by a bf16 step of its size.  out: the largest
# and the mean absolute difference; m and l: the largest difference over
# max(|plain|, 1).  f32: the dense oracle's 2e-5 of
# tests/parallel/test_flash.py.  bf16: each limit lies between the
# readings of the sound kernel on these seeded inputs and of planted
# faults (PERF.md, PR 3: a dropped diagonal key tile, the exponential of
# the unrounded argument, unrounded weights in P.V).  Sound at most /
# faults at least: out max 3.9e-3 (one bf16 step below |out| = 1) /
# 7.8e-3, out mean 3.7e-7 / 8.2e-5, m and l 3.4e-4 / 2.7e-3 (the P.V
# fault leaves m and l as they are).  The bf16 tensor-core kernel is held
# to the same limits, read again against FLASH_FAULTS (PERF.md §6).  The
# f32 kernel (3xTF32 on the tensor cores) also drops each product's
# small*small term and sums each k-step's products in the tensor cores:
# sound at most out max 1.3e-6, mean 3.9e-8, m and l 4.2e-6 (l at the
# training shape); each fault of F32_FLASH_FAULTS at its worst at least
# out max 2.0e-3, mean 4.7e-5 (one_pass: one TF32 product a pair).
FLASH_LIMITS = {
    torch.float32: {"out_max": 2e-5, "out_mean": 1e-6, "stat": 1e-5},
    torch.bfloat16: {"out_max": 6e-3, "out_mean": 5e-6, "stat": 1e-3},
}
# the decode path's last-prompt-position logits, kernel prefill against
# plain prefill, bf16: 8 layers of bf16 activations, each of whose
# elements may move by a bf16 step (2^-8 of its size) where the
# attention output did; held to 5e-2 of the largest logit
DECODE_LOGIT_RTOL = 5e-2

# the long-prompt serving point (docs/performance.md:1347-1357) on the
# decode benchmark's model (benchmarks/transformer.py:358-362)
DECODE_CFG = tfm.TransformerConfig(
    vocab=32768, d_model=512, layers=8, heads=8, kv_heads=8, head_dim=64,
    d_ff=2048,
)
LONG = transformer_decode.LONG
# the f32 token-identity check, kernel path against plain path
F32_DECODE = dict(batch=2, prompt=1024, max_len=1152)
# the categorical decode held to its eager run on the graphs
CATEGORICAL = dict(temperature=0.8, top_k=50, seed=1234)

# the long-context training preset (benchmarks/transformer.py:71-74) as
# written: full width and depth, bf16, remat="names"
TRAIN = transformer_train.SIZES["long"]
TRAIN_CFG = tfm.TransformerConfig(
    vocab=32768, d_model=TRAIN["d_model"], layers=TRAIN["layers"],
    heads=TRAIN["heads"], kv_heads=TRAIN["kv_heads"],
    head_dim=TRAIN["d_model"] // TRAIN["heads"], d_ff=TRAIN["d_ff"],
    attn_impl=TRAIN["attn_impl"],
)
TRAIN_LR = 1e-3  # run's SGD rate (benchmarks/transformer.py:252)
TRAIN_TIMED_STEPS = 3
TRAIN_CHECK_LAYERS = 2
# flash launches per layer of one bf16 training step under a remat
# policy: the bf16 kernels, the forward twice (the backward's recompute
# runs it again, as JAX's policies do), and none of the f32 ones
TRAIN_LAUNCHES = {"flash_fwd": 0, "flash_fwd_mma": 2, "flash_bwd_dkv": 0,
                  "flash_bwd_dq": 0, "flash_bwd_dkv_mma": 1,
                  "flash_bwd_dq_mma": 1}
# flash launches per layer of one bf16 training step without remat (the
# bench's small preset): each bf16 kernel once
NO_REMAT_LAUNCHES = dict(TRAIN_LAUNCHES, flash_fwd_mma=1)
# the bench's training legs: the preset each runs and its flash launches
# per layer of one step
BENCH_TRAIN_LEGS = {"transformer": ("small", NO_REMAT_LAUNCHES),
                    "transformer_large": ("large", TRAIN_LAUNCHES),
                    "long_context": ("long", TRAIN_LAUNCHES)}
# the MFU preset (benchmarks/transformer.py:58-61): its attention shape is
# one more case of the flash kernels' checks and timings
LARGE = transformer_train.SIZES["large"]
LARGE_SHAPE = (LARGE["batch"], LARGE["seq"], LARGE["seq"], LARGE["heads"],
               LARGE["kv_heads"], LARGE["d_model"] // LARGE["heads"])
# the remat policies held on the card at the 2-layer bf16 gradient check
REMAT_POLICIES = (True, "dots", "names", ("attn_out", "mlp_out"),
                  tfm.CHECKPOINT_NAMES)
# the transformer across a mesh of ranks on one card: four thread ranks
# over gloo on the JAX bench's 4-device training mesh (dp, tp, sp) =
# (1, 2, 2) (benchmarks/transformer.py:218-224), at the long preset's
# width, cut to 2 layers, batch 2 a dp rank and seq 2048 a sp rank
MESH_TRAIN = (1, 2, 2)
MESH_TRAIN_CFG = TRAIN_CFG._replace(layers=2)
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 2048
# the schemes: (name, sequence, ring layout), each under remat="names"
MESH_SCHEMES = (("ring", "ring", "contiguous"),
                ("ring_zigzag", "ring", "zigzag"),
                ("ulysses", "ulysses", None))
# the f32 check's SGD rate: lr 1 makes the update the gradient itself
MESH_CHECK_LR = 1.0
# a scheme's loss and updated leaves against the one-rank step on the
# same global batch, f32: the loss's relative difference and per leaf
# max|difference| over max|one-rank update|, each within this limit
# (PERF.md §6: the sound schemes' readings and a planted fault's, a
# gradient sync that skips sp, lie either side of it)
MESH_TRAIN_LIMIT = 1e-3
# the decoder on the JAX bench's decode mesh (dp, tp) = (2, 2)
# (benchmarks/transformer.py:377-380) at the decode model's width, f32,
# greedy, a short prompt: its tokens equal the one-rank decoder's
MESH_DECODE = (2, 2)
MESH_DECODE_RUN = dict(batch=4, prompt=16, max_len=48)
# the flash kernels' shapes on this slice's path: Ulysses's full-sequence
# attention at the long leg on (1, 2, 2) (16 heads / tp 2 / sp 2 over
# 16384 tokens) and the decode prefill at tp 2 (8 heads / 2)
ULYSSES_LONG_SHAPE = (TRAIN["batch"], 2 * TRAIN["seq"], 2 * TRAIN["seq"],
                      TRAIN["heads"] // 4, TRAIN["kv_heads"] // 4,
                      TRAIN["d_model"] // TRAIN["heads"])
PREFILL_TP2_SHAPE = (LONG["batch"], LONG["prompt"], LONG["prompt"],
                     DECODE_CFG.heads // 2, DECODE_CFG.kv_heads // 2,
                     DECODE_CFG.head_dim)
# the f32 gradient check: the decode model's width (flash attention) at
# batch 2, seq 1024, the f32 kernels once per layer each
F32_TRAIN_CFG = DECODE_CFG._replace(attn_impl="flash")
F32_TRAIN = dict(batch=2, seq=1024)

# backward kernels against their plain versions, per gradient (dq, dk,
# dv).  They differ by the summation order (and in the f32 kernels by the
# dropped small*small terms of 3xTF32): in f32 by a few ulps, in bf16
# where an output rounds to the other bf16 neighbour, or where the two f32
# scores round their exponential's argument (bf16, as the forward does)
# to neighbouring values, which moves that weight by up to 2^-7 of
# |s - m|.  f32: the largest and the mean absolute difference over
# max|plain|, each between the sound kernels' readings and those of the
# planted faults of BWD_FAULTS (PERF.md §6); sound at most / each fault's
# worst case at least: max 6.0e-6 / 1.2e-3, mean 5.4e-8 / 3.5e-5
# (one_pass: one TF32 product a pair).  bf16: the largest difference in
# bf16 steps of max|plain| ("top_steps": a value in [2^(e-1), 2^e) has a
# step of 2^(e-8)) and the mean absolute difference over max|plain|.
# Kernel and plain version are equally far from a float64 witness (the
# exact gradient from the same bf16 inputs; --witness-readings, PERF.md
# §6).  While their f32 values differ by less than one step of
# max|plain|, rounding to bf16 moves an element of the top binade by at
# most one step and any other by less than 1.5: a rounding flip cannot
# fail the limit, two steps at the top do.  Sound at most 0.5 steps
# (3.1e-3 of max|plain|) over every case on four seeds, the mean at most
# 1.9e-7.  Every fault of BWD_MMA_FAULTS fails: the dropped tiles, the
# swapped mask and the skipped diagonal by at least 3.8 steps where they
# strike, ds_hi_only and dv_trunc by their mean on every case (at least
# 1.1e-5 and 1.6e-5, at the path shape).
# The per-element measure (steps of each element's own size, floored at
# 2^-8 max|plain|) read up to 36 on the sound kernels: a flipped weight
# moves a small element by many of its own steps.
BWD_LIMITS = {
    torch.float32: {"max": 1e-5, "mean": 1e-6},
    torch.bfloat16: {"top_steps": 1.5, "mean": 1e-6},
}
# every backward case runs on its own seed (its index) and on this many
# more (extra_seeds), so that a limit is not read on one draw alone
BWD_EXTRA_SEEDS = 3
# --witness-readings: the bf16 backward cases whose kernels and plain
# versions are read against a float64 witness, each on this many seeds
WITNESS_CASES = ("gqa_bf16", "d64_bf16", "padding_bf16", "path")
WITNESS_SEEDS = 8
# the 2-layer training gradient, kernel path against plain path, bf16:
# per leaf max|difference| over max|plain|.  The attention outputs and
# gradients of the two paths differ by bf16 steps where a sum rounds the
# other way, and every later bf16 activation carries that on; readings
# 2.2e-3 (ln_f) to 1.25e-2 (embed), PERF.md §6.
TRAIN_GRAD_LIMIT = 5e-2
# ... which cannot see a forward kernel that drops the diagonal key tile
# of half the query rows (FLASH_FAULTS["diag_tile"]: 2.1e-2 to 3.8e-2 on
# four seeds), since a sound kernel's rare rounding flips move a few
# elements as far.  So each path is also read against a float64
# witness, the exact gradient of the same loss from the same bf16 inputs
# (witness_loss_and_grads), and per leaf the kernel path's mean
# |difference| from it may exceed the plain path's by at most this
# factor ("ratio"), on seed 1 and this many more.  Readings (PERF.md §6),
# every leaf of four seeds: sound 0.985-1.015; diag_tile 1.54-2.35.  The mean difference between the two paths alone
# does not separate them: sound 5.8e-5 (head) to 1.2e-3 (ln1), the fault
# 1.8e-4 (head) to 4.3e-3 (ln2).
TRAIN_WITNESS_RATIO = 1.2
TRAIN_GRAD_EXTRA_SEEDS = 3
# a remat policy's loss and gradient against the kernel path's without
# remat: equal bit for bit (torch.equal).  The recompute runs the same
# kernels and GEMMs on the same inputs, and every policy read so on four
# seeds (PERF.md §6); a policy that saved or replayed a wrong tensor
# moves some leaf.  Each policy's path is also held to the float64
# witness as the kernel path is (TRAIN_WITNESS_RATIO).
# the same in f32: the f32 kernels differ from their plain versions by
# f32 summation order (about 1e-6 of the largest output: FLASH_LIMITS,
# BWD_LIMITS), which two layers carry through LayerNorm and the matmuls'
# backward; 1e-3 of a leaf's largest gradient leaves room for
# cancellation in the small leaves and is 50x under the bf16 limit
F32_GRAD_LIMIT = 1e-3
# faults planted in copies of flash_fwd_mma.cu for --fault-readings, each
# an exact replacement: the query tiles in the lower half of the rows drop
# their diagonal key tile; the exponential of the unrounded argument; the
# causal mask applied with the C fragment's row and column swapped; the
# accumulator not rescaled by corr
FLASH_FAULTS = {
    "diag_tile": (
        "if (needed < n_tiles) n_tiles = static_cast<int>(needed);",
        "if (needed < n_tiles) n_tiles = static_cast<int>(needed);\n"
        "    if (2 * q0 >= Tq) --n_tiles;",
    ),
    "exp_arg": (
        "const float arg = __bfloat162float(__float2bfloat16_rn(x));",
        "const float arg = x;",
    ),
    "mask_swap": (
        "if (mask_causal && qpos[e / 2] < k_offset + key) x = kNeg;",
        "if (mask_causal && q_offset + row0 + 2 * t + e % 2 < k_offset + k0 "
        "+ 8 * n + g + 8 * (e / 2)) x = kNeg;",
    ),
    "no_corr": (
        "acc[n][e] = acc[n][e] * corr[e / 2];",
        "acc[n][e] = acc[n][e];",
    ),
}
# faults planted in copies of flash_fwd.cu (f32, 3xTF32) for
# --fault-readings, each an exact replacement: the query tiles in the
# lower half of the rows drop their diagonal key tile; the causal mask
# applied with the C fragment's row and column swapped; the accumulator
# not rescaled by corr; the small terms dropped (one TF32 product a pair,
# 1xTF32: the readings must see the split)
F32_FLASH_FAULTS = {
    "diag_tile": FLASH_FAULTS["diag_tile"],
    "mask_swap": (
        "if (mask_causal && qpos[e / 2] < k_offset + key) x = kNeg;",
        "if (mask_causal && q_offset + row0 + 2 * t + e % 2 < k_offset + k0 "
        "+ kHalfK * kh + 8 * n + g + 8 * (e / 2)) x = kNeg;",
    ),
    "no_corr": (
        "acc[n][e] = acc[n][e] * corr[e / 2] + part[e];",
        "acc[n][e] = acc[n][e] + part[e];",
    ),
    "one_pass": (
        "constexpr int kProducts = 3;",
        "constexpr int kProducts = 1;",
    ),
}
# faults planted in copies of flash_bwd.cu (f32) for --fault-readings,
# each an exact replacement: the dkv kernel drops the diagonal query tile
# of the key blocks in the lower half of the rows; query tiles are skipped
# by the diagonal alone, which loses the fully masked rows' dO/n; both
# kernels' small terms dropped (1xTF32); the dq kernel drops its diagonal
# key tile for the query tiles in the lower half of the rows; dq's causal
# mask applied with the C fragment's row and column swapped
BWD_FAULTS = {
    "diag_tile": (
        "first = tile < n_tiles ? static_cast<int>(tile) : n_tiles;",
        "first = tile < n_tiles ? static_cast<int>(tile) + "
        "(2 * tile * kQTile >= Tq ? 1 : 0) : n_tiles;",
    ),
    "diagonal_skip": (
        "if (causal && q_offset >= k_offset) {",
        "if (causal) {",
    ),
    "one_pass": (
        "constexpr int kProducts = 3;",
        "constexpr int kProducts = 1;",
    ),
    "dq_diag_tile": FLASH_FAULTS["diag_tile"],
    "dq_mask_swap": (
        "if (mask_causal && qpos[e / 2] < k_offset + key) seen = false;",
        "if (mask_causal && q_offset + row0 + 2 * t + e % 2 < k_offset + k0 "
        "+ kHalfK * kh + gr + 8 * (e / 2)) seen = false;",
    ),
}
# faults planted in copies of flash_bwd_mma.cu (bf16) for
# --fault-readings, each an exact replacement: dq drops its diagonal key
# tile for the query tiles in the lower half of the rows; dkv drops its
# diagonal query tile for the key blocks in the lower half; the causal
# mask applied with the C fragment's row and column swapped; query tiles
# skipped by the diagonal alone; ds's mid and lo terms dropped; the dV
# weights packed to bf16 by truncation instead of round-to-nearest
BWD_MMA_FAULTS = {
    "dq_diag_tile": (
        "if (needed < n_tiles) n_tiles = static_cast<int>(needed);",
        "if (needed < n_tiles) n_tiles = static_cast<int>(needed);\n"
        "    if (2 * q0 >= Tq) --n_tiles;",
    ),
    "dkv_diag_tile": (
        "first = tile < n_tiles ? static_cast<int>(tile) : n_tiles;",
        "first = tile < n_tiles ? static_cast<int>(tile) + "
        "(2 * tile * kQTile >= Tq ? 1 : 0) : n_tiles;",
    ),
    "mask_swap": (
        "if (mask_causal && q_offset + q0 + i < kpos[e / 2]) {",
        "if (mask_causal && q_offset + q0 + 16 * c + 8 * n + gr + 8 * (e / 2)"
        " < k_offset + kw0 + 2 * t + e % 2) {",
    ),
    "diagonal_skip": (
        "if (causal && q_offset >= k_offset) {",
        "if (causal) {",
    ),
    "ds_hi_only": (
        "constexpr int kTerms = 3;",
        "constexpr int kTerms = 1;",
    ),
    "dv_trunc": (
        "return pack_bf16(a, b);",
        "return (__float_as_uint(a) >> 16) | "
        "(__float_as_uint(b) & 0xffff0000u);",
    ),
}
# planted and read by --fault-readings but not judged: ds's lo term
# dropped, what the third term buys; dK accumulated by mma.sync itself
# over all the query rows instead of one 16-row chunk at a time, what the
# CUDA-core accumulation buys (PERF.md §6)
BWD_MMA_READINGS = {
    "ds_two_terms": (
        "constexpr int kTerms = 3;",
        "constexpr int kTerms = 2;",
    ),
    "mma_accumulates_dk": (
        "          mma_16816(dk_part[0], da[term], r[0], r[1]);\n"
        "          mma_16816(dk_part[1], da[term], r[2], r[3]);\n"
        "        }\n"
        "        accumulate(dk_acc[n], dk_part[0]);\n"
        "        accumulate(dk_acc[n + 1], dk_part[1]);",
        "          mma_16816(dk_acc[n], da[term], r[0], r[1]);\n"
        "          mma_16816(dk_acc[n + 1], da[term], r[2], r[3]);\n"
        "        }",
    ),
}
# faults planted in copies of sw_step.cu for --fault-readings, each an
# exact replacement in sw_main: the strip's prologue no longer hands
# q(r-1) and fn(r-1) to its first row, which reads the zeros they start
# from; the western potential vorticity taken from two lanes west; the
# northern flux no longer zero on the ring rows beyond a wall
SW_FAULTS = {
    "prologue": (
        "    q_s = q_c;\n    fn_s = fn_c;\n",
        "    if (r >= r0) {\n      q_s = q_c;\n      fn_s = fn_c;\n    }\n",
    ),
    "west_lane": (
        "__shfl_up_sync(kAll, q_c, 1)",
        "__shfl_up_sync(kAll, q_c, 2)",
    ),
    "fn_wall": (
        "const bool fn_zero = wall_c || (g.is_north && r == g.ny_l + 1);",
        "const bool fn_zero = g.is_north && r == g.ny_l + 1;",
    ),
}
# sw_main against its plain version beside the bench shape: (name,
# (ny_l, nx_l), is_south, is_north, iy).  Blocks whose widths are no
# multiple of a warp's 30 columns and whose heights are no multiple of a
# strip's 4 rows; both walls (one rank, as the path), then each wall
# alone on the block of a second rank in y (iy = 1)
SW_CHECK_CASES = (
    ("walls", (45, 97), True, True, 0),
    ("south_iy1", (61, 143), True, False, 1),
    ("north_iy1", (61, 143), False, True, 1),
)
# the planted copies of --fault-readings: (copy name prefix, source in
# kernels/csrc, faults, the checks each copy runs, whether a copy must
# fail); the forward's diag_tile copy (bf16) also runs the gradients
FAULT_PLANS = (
    ("sw_", "sw_step.cu", SW_FAULTS, "sw", True),
    ("fwd_", "flash_fwd_mma.cu", FLASH_FAULTS, "fwd", True),
    ("fwd32_", "flash_fwd.cu", F32_FLASH_FAULTS, "fwd", True),
    ("bwd_", "flash_bwd.cu", BWD_FAULTS, "bwd", True),
    ("bwd_mma_", "flash_bwd_mma.cu", BWD_MMA_FAULTS, "bwd", True),
    ("bwd_mma_", "flash_bwd_mma.cu", BWD_MMA_READINGS, "bwd", False),
)


def log(msg):
    print(msg, flush=True)


def card_lines():
    """Every card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def card_line():
    return card_lines()[0]


def rel_close(expected, actual, tol):
    """(ok, max_abs_err, max_err / scale): allclose with rtol=tol and
    atol=tol * max|expected|, the metric of
    research/test_sw_step_pallas.py."""
    scale = max(expected.abs().max().item(), 1e-30)
    err = (expected - actual).abs().max().item()
    ok = torch.allclose(actual, expected, rtol=tol, atol=tol * scale)
    return bool(ok), err, err / scale


def time_ms(fn, n=TIMED_LAUNCHES, repeats=5, warmup=3):
    """Device time of one call of ``fn``: CUDA events around ``n``
    back-to-back calls, so the host's launch cost overlaps the device
    work, divided by ``n``; the median of ``repeats`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def library_kernels(fn, top=3):
    """The device kernels that one call of ``fn`` ran, the longest
    first, from a torch.profiler trace: which kernel a library call
    timed beside a hand-written one took.  None where the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    return sorted(us, key=us.get, reverse=True)[:top] or None


def copy_bytes_per_s(device):
    """Device-to-device copy rate of 512 MiB: bytes read plus bytes
    written per second."""
    n = 128 * 1024 * 1024
    src = torch.ones(n, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), n=20)
    return 2 * n * 4 / (ms * 1e-3)


def plain_step(state, cfg, comm, first_step):
    """The solver's step with the plain versions of both kernels."""
    state, _ = sw._step(
        state, cfg, comm, first_step=first_step, token=None,
        main=sw_step.sw_main_reference, visc=sw_step.sw_visc_reference,
    )
    return state


def clone(state):
    return sw.SWState(*(t.clone() for t in state))


def sw_bench_inputs(cfg, comm, device):
    """sw_main's inputs at this rank's block (the bench shape on one
    rank) as the step gives them: a non-trivial state (the initial state plus a few plain steps, v != 0)
    with h, u, v exchanged and h's wall ghost rows clamped.  Returns
    ``(state, inputs, geometry, iy)``."""
    ny_l, nx_l = cfg.local_interior(comm)
    is_north, is_south = sw._wall_masks(comm)
    iy, _ = sw._device_coords(comm)
    geometry = dict(cfg=cfg, ny_l=ny_l, nx_l=nx_l, is_south=is_south,
                    is_north=is_north)
    state = sw.make_init(cfg, comm, device=device)()
    state = plain_step(state, cfg, comm, True)
    for _ in range(4):
        state = plain_step(state, cfg, comm, False)
    if state.v.abs().max().item() == 0.0:
        raise RuntimeError("kernel-phase state has v == 0")
    h, u, v, dh, du, dv = clone(state)
    for f in (h, u, v):
        halo_exchange_2d(f, comm, periodic=(False, True), width=cfg.ghost)
    sw.clamp_wall_ghost_rows(h, comm, ny_l)
    return state, (h, u, v, dh, du, dv), geometry, iy


def sw_case_inputs(cfg, interior, seed, device):
    """Fields of an ``interior`` block with its ghost ring, from
    ``seed``: h about the depth, u and v about 1 m/s, tendencies about
    1e-4."""
    gen = torch.Generator().manual_seed(seed)
    shape = (interior[0] + 4, interior[1] + 4)

    def draw(scale, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=gen)).to(device)

    return (draw(1.0, cfg.depth), draw(1.0), draw(1.0), draw(1e-4),
            draw(1e-4), draw(1e-4))


def sw_main_checks(inputs, geometry, iy, device):
    """sw_main held to its plain version bit for bit (``torch.equal``),
    with the largest difference beside it: at the bench shape's
    ``inputs`` and at ``SW_CHECK_CASES``, each for both first_step
    values; every case runs before a failure raises.  Then one bench
    launch captured in a CUDA graph and replayed must equal the eager
    launch.  Returns the bench shape's ``{first_step: (max_abs_err,
    max_err / max|plain|)}`` and its AB2 outputs."""
    cfg = geometry["cfg"]
    cases = [("bench", inputs, geometry, iy)]
    for seed, (name, interior, south, north, case_iy) in enumerate(
            SW_CHECK_CASES):
        cases.append((name, sw_case_inputs(cfg, interior, seed, device),
                      dict(cfg=cfg, ny_l=interior[0], nx_l=interior[1],
                           is_south=south, is_north=north), case_iy))
    bench, failed = {}, []
    for case, args, geo, case_iy in cases:
        for first_step in (True, False):
            kw = dict(iy=case_iy, first_step=first_step, **geo)
            got = sw_step.sw_main(*args, **kw)
            want = sw_step.sw_main_reference(*args, **kw)
            torch.cuda.synchronize()
            worst_abs, worst_rel = 0.0, 0.0
            for name, w, g in zip(sw.SWState._fields, want, got):
                # the tolerance the first form was held to, read beside
                # the bit-exact verdict
                tol = KERNEL_TOL["tendency" if name.startswith("d")
                                 else "state"]
                close, err, rel = rel_close(w, g, tol)
                ok = torch.equal(w, g)
                log(f"  sw_main {case} {tuple(args[0].shape)} first_step="
                    f"{first_step} {name}: max_abs_err {err:.3e}, "
                    f"max_err/max|plain| {rel:.3e} "
                    f"({'within' if close else 'outside'} {tol:g}; "
                    f"bit-exact required) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{case} first_step={first_step} {name}")
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if case == "bench":
                bench[first_step] = (worst_abs, worst_rel)
                main_out = got  # the AB2 case: the main path's launch
    if failed:
        raise RuntimeError(f"sw_main differs from its plain version: "
                           f"{', '.join(failed)}")

    # the same launch captured in a CUDA graph and replayed (the solver's
    # chunks are graphs; the kernel library links its own CUDA runtime
    # and launches on PyTorch's stream, which the capture must record)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        replayed = sw_step.sw_main(*inputs, iy=iy, first_step=False,
                                   **geometry)
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(main_out, replayed))
    log(f"  sw_main captured in a CUDA graph and replayed: "
        f"{'bit-identical to' if same else 'DIFFERS from'} the eager launch")
    if not same:
        raise RuntimeError("a replayed sw_main launch differs from the "
                           "eager one")
    return bench, main_out


def kernel_phase(cfg, comm, device, copy_rate):
    state, inputs, geometry, iy = sw_bench_inputs(cfg, comm, device)
    rows, cols = inputs[0].shape
    cells = rows * cols
    interior = geometry["ny_l"] * geometry["nx_l"]
    per = (False, True)
    bench, main_out = sw_main_checks(inputs, geometry, iy, device)
    results = {f"sw_main_first_step_{k}": err for k, err in bench.items()}

    # viscosity inputs: the main kernel's u, v after their exchange
    u2, v2 = main_out[1].clone(), main_out[2].clone()
    for f in (u2, v2):
        halo_exchange_2d(f, comm, periodic=per, width=cfg.ghost)
    got = sw_step.sw_visc(u2, v2, **geometry)
    want = sw_step.sw_visc_reference(u2, v2, **geometry)
    torch.cuda.synchronize()
    # the viscosity kernel computes every value as the plain version's
    # expression of the same operands: held to bit equality
    worst_abs, worst_rel = 0.0, 0.0
    for name, w, g in zip("uv", want, got):
        _, err, rel = rel_close(w, g, KERNEL_TOL["state"])
        ok = torch.equal(w, g)
        log(f"  sw_visc {name}: max_abs_err {err:.3e}, max_err/max|plain| "
            f"{rel:.3e} (bit-exact required) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"sw_visc disagrees with its plain version "
                               f"on {name}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    results["sw_visc"] = (worst_abs, worst_rel)

    # timing at the main path's shapes; each call allocates its outputs
    # as the step does
    ab2 = dict(iy=iy, first_step=False, **geometry)
    timings = {
        "sw_main": (
            time_ms(lambda: sw_step.sw_main(*inputs, **ab2)),
            time_ms(lambda: sw_step.sw_main_reference(*inputs, **ab2)),
            12 * cells * 4,
            FLOPS_PER_CELL["sw_main"] * interior,
            "research/sw_step_pallas.py:98",
            results["sw_main_first_step_False"],
        ),
        "sw_visc": (
            time_ms(lambda: sw_step.sw_visc(u2, v2, **geometry)),
            time_ms(lambda: sw_step.sw_visc_reference(u2, v2, **geometry)),
            4 * cells * 4,
            FLOPS_PER_CELL["sw_visc"] * interior,
            "research/sw_step_pallas.py:217",
            results["sw_visc"],
        ),
    }
    kernels = []
    for name, (ms, plain_ms, nbytes, flops, replaces, err) in timings.items():
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_F32_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        copy_bound_ms = nbytes / copy_rate * 1e3
        log(f"  {name}: {ms:.4f} ms per launch, median of 5 runs of "
            f"{TIMED_LAUNCHES} (plain {plain_ms:.4f} ms), {nbytes / 1e6:.1f} MB, "
            f"bound {bound_ms:.4f} ms by "
            f"{'bytes' if bytes_ms >= flops_ms else 'operations'} at the "
            f"data-sheet peak, {copy_bound_ms:.4f} ms at the measured copy "
            f"rate ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s achieved)")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpi4jax_tpu_torch/kernels/csrc/sw_step.cu",
            "replaces": replaces,
            "launches": None,  # filled from the path phase
            "max_abs_err": err[0],
            "max_rel_err": err[1],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes it
            "copy_bound_ms": copy_bound_ms,
            "bytes": nbytes,
            "flops": flops,
        })
    return kernels, state


def reset_launch_counts():
    sw_step.reset_launch_counts()
    kflash.reset_launch_counts()
    kbwd.reset_launch_counts()


def launch_counts():
    """Launches of each kernel since the counts were last set to 0 (each
    flash wrapper counts both its kernels and its bf16 one in
    ``mma_launches``).  The shallow-water wrappers count eager launches
    only; a graph's launches are its replays times the launches its
    capture recorded (``make_multistep``'s ``replays`` and
    ``captured``)."""
    fwd, dkv, dq = kflash.flash_fwd, kbwd.flash_bwd_dkv, kbwd.flash_bwd_dq
    return {"sw_main": sw_step.sw_main.launches,
            "sw_visc": sw_step.sw_visc.launches,
            "flash_fwd": fwd.launches - fwd.mma_launches,
            "flash_fwd_mma": fwd.mma_launches,
            "flash_bwd_dkv": dkv.launches - dkv.mma_launches,
            "flash_bwd_dq": dq.launches - dq.mma_launches,
            "flash_bwd_dkv_mma": dkv.mma_launches,
            "flash_bwd_dq_mma": dq.mma_launches}


def path_phase(cfg, comm, device, kernels, state0, card):
    days = 0.1
    chunk = 25
    solve = sw.make_solver(cfg, comm, num_multisteps=chunk, device=device)
    multi = solve.multistep
    reset_launch_counts()
    state, wall, steps = solve(days * sw.DAY_IN_SECONDS)
    launches = launch_counts()
    total_steps = 1 + chunk + steps  # bootstrap, warm-up chunk, timed chunks
    log(f"  make_solver: {steps} timed steps in {wall:.4f} s, "
        f"{total_steps} steps in all; eager launches {launches}; "
        f"{multi.replays} graph replays of {multi.captured} launches")
    for k in kernels:
        eager = launches[k["name"]]
        captured = multi.captured.get(k["name"], 0)
        k["launches"] = eager + multi.replays * captured
        if k["launches"] == 0:
            raise RuntimeError(f"the main path never launched {k['name']}")
        if captured != chunk or multi.replays * chunk != steps:
            raise RuntimeError(
                f"{k['name']}: {multi.replays} replays of {captured} "
                f"captured launches for {steps} timed steps of {chunk}-step "
                f"chunks")
        if k["launches"] != total_steps:
            raise RuntimeError(
                f"{k['name']} launched {eager} times eagerly and "
                f"{multi.replays} x {captured} times from the graph in "
                f"{total_steps} steps")
        log(f"  {k['name']}: {eager} eager + {multi.replays} replays x "
            f"{captured} captured = {k['launches']} launches = "
            f"{total_steps} steps ok")

    for name, t in zip(sw.SWState._fields, state):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name} is not finite after the solver run")
    G = cfg.ghost
    mean_h = state.h[G:-G, G:-G].double().mean().item()
    if not math.isclose(mean_h, cfg.depth, rel_tol=MASS_RTOL):
        raise RuntimeError(f"mass not conserved: mean h {mean_h} vs depth "
                           f"{cfg.depth}")
    log(f"  mean(h interior) {mean_h:.7f} vs depth {cfg.depth} "
        f"(rtol {MASS_RTOL:g}) ok")
    rate = cfg.ny * cfg.nx * steps / wall
    step_ms = wall / steps * 1e3
    kernel_ms = sum(k["ms"] for k in kernels)
    log(f"  {rate:.4e} cell-updates/s, {step_ms:.4f} ms per step "
        f"(kernels {kernel_ms:.4f} ms of it), on {card}")
    replays = multi.replays
    del solve, multi, state

    # 25 steps on the kernel path and on the plain path, same start
    fast = sw.make_multistep(cfg, comm, 25)(clone(state0))
    plain = clone(state0)
    for _ in range(25):
        plain = plain_step(plain, cfg, comm, False)
    torch.cuda.synchronize()
    for name, p, f in zip(sw.SWState._fields, plain, fast):
        ok, err, rel = rel_close(p, f, PATH_TOL)
        log(f"  25 steps kernel vs plain {name}: max_err/max|plain| "
            f"{rel:.3e} (limit {PATH_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel path and plain path disagree on "
                               f"{name} after 25 steps")
    return {"cell_updates_per_s": rate, "step_ms": step_ms,
            "timed_steps": steps, "wall_s": wall, "graph_replays": replays}


def device_trace(fn):
    """``fn()`` under torch.profiler, synchronised: ``(per_kernel,
    span_ms)``: device ms and launches by kernel name, and the device
    timeline's span (first kernel's start to last kernel's end)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = {}
    first, last = math.inf, -math.inf
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        # the ops' record_function ranges span kernels on the device side
        # and are no device work of their own
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            total, count = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (total + ms, count + 1)
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    span_ms = (last - first) / 1e3 if per_kernel else 0.0
    return per_kernel, span_ms


def kernel_launches(per_kernel, name):
    """(device ms, launches) of the kernel ``name`` in a trace."""
    hits = [(ms, count) for kname, (ms, count) in per_kernel.items()
            if f"{name}_kernel(" in kname]
    return sum(ms for ms, _ in hits), sum(count for _, count in hits)


def profile_phase(cfg, comm, state, step_ms, kernels, n_steps=25):
    """Where a step's time goes under the graph: one replay of an
    ``n_steps`` chunk (as the path runs it: donated, chained) under
    torch.profiler, against the untraced step time of the path phase.
    Each kernel must show ``n_steps`` device launches in the replay;
    each entry of ``kernels`` gets its device ms per launch in the trace
    (``profile_ms``): the kernel phase's timing of back-to-back wrapper
    calls reads the wrapper's host time instead where that is longer."""
    multi = sw.make_multistep(cfg, comm, n_steps, donate=True)
    s = multi(clone(state))  # the eager chunk, then the capture
    s = multi(s)  # copied into the graph's buffers, replayed
    per_kernel, span_ms = device_trace(lambda: multi(s))
    if not per_kernel:
        raise RuntimeError("the profiler recorded no device activity in a "
                           "graph replay: the kernels' launches are not "
                           "shown")
    busy = sum(ms for ms, _ in per_kernel.values()) / n_steps
    span = span_ms / n_steps
    log(f"  one graph replay of {n_steps} steps: device busy {busy:.4f} ms "
        f"per step in a device timeline of {span:.4f} ms per step (idle "
        f"share {1 - busy / span:.4f}); {step_ms:.4f} ms per step untraced "
        f"under the graph (busy / untraced {busy / step_ms:.3f}; tracing "
        f"lengthens the kernels)")
    for k in kernels:
        ms, count = kernel_launches(per_kernel, k["name"])
        log(f"  {k['name']}: {count} device launches in the replay "
            f"({'ok' if count == n_steps else 'FAIL'}, {n_steps} steps)")
        if count != n_steps:
            raise RuntimeError(f"{k['name']} launched {count} times in a "
                               f"replay of {n_steps} steps")
        k["profile_ms"] = ms / count
        log(f"  {k['name']}: {k['profile_ms']:.4f} ms of device time "
            f"per launch in the trace (kernel phase {k['ms']:.4f} ms)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, count) in top:
        log(f"    {ms / n_steps:.4f} ms/step, {count / n_steps:g} "
            f"launches/step: {name[:90]}")
    return {"device_busy_ms_per_step": busy,
            "device_span_ms_per_step": span,
            "idle_share": 1 - busy / span,
            "busy_over_untraced_step": busy / step_ms,
            "launches_per_step": sum(c for _, c in per_kernel.values())
            / n_steps}


def schedules_phase(cfg, comm, device, n_steps=25):
    """Ghost 1, 2 and 4 at ``cfg``'s size through ``make_multistep``:
    replay against eager bit for bit, the schedules against each other,
    ghost 4's mass, ms per step under the graph, device time and idle
    share of one traced replay; bfloat16 at ghost 1 and 4; ghost 2 in
    bfloat16 refused on the card."""
    result, h = {}, {}
    for ghost in (1, 2, 4):
        cfg_g = dataclasses.replace(cfg, ghost=ghost)
        start = sw.make_first_step(cfg_g, comm)(
            sw.make_init(cfg_g, comm, device=device)())
        multi = sw.make_multistep(cfg_g, comm, n_steps, donate=True)
        eager = multi(clone(start))  # the eager chunk, then the capture
        replay = multi(clone(start))  # the graph
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(eager, replay))
        log(f"  ghost {ghost}: {n_steps} steps replayed from the graph "
            f"{'equal' if same else 'DIFFER from'} the eager chunk bit for "
            f"bit; captured launches {multi.captured}")
        if not same:
            raise RuntimeError(f"ghost {ghost}: the graph replay differs "
                               f"from the eager steps")
        G = ghost
        h[ghost] = replay.h[G:-G, G:-G].double()
        mean_h = h[ghost].mean().item()
        if ghost == 4 and not math.isclose(mean_h, cfg.depth,
                                           rel_tol=MASS_RTOL):
            raise RuntimeError(f"ghost 4: mass not conserved: mean h "
                               f"{mean_h} vs depth {cfg.depth}")
        del eager, start
        s = replay
        calls = 4
        t0 = time.perf_counter()
        for _ in range(calls):
            s = multi(s)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (calls * n_steps) * 1e3
        per_kernel, span_ms = device_trace(lambda: multi(s))
        busy = sum(ms for ms, _ in per_kernel.values()) / n_steps
        span = span_ms / n_steps
        launches = sum(c for _, c in per_kernel.values()) / n_steps
        result[f"ghost{ghost}"] = {
            "step_ms": step_ms, "device_busy_ms_per_step": busy,
            "device_span_ms_per_step": span, "idle_share": 1 - busy / span,
            "launches_per_step": launches, "mean_h": mean_h,
            "cell_updates_per_s": cfg.ny * cfg.nx / (step_ms * 1e-3),
        }
        log(f"  ghost {ghost}: {step_ms:.4f} ms per step under the graph "
            f"({cfg.ny * cfg.nx / (step_ms * 1e-3):.4e} cell-updates/s); "
            f"one traced replay: device busy {busy:.4f} ms per step of a "
            f"{span:.4f} ms timeline (idle share {1 - busy / span:.4f}), "
            f"{launches:g} launches per step; mean h {mean_h:.7f}")
        del multi, s, replay

    for ghost in (2, 4):
        err = (h[ghost] - h[1]).abs().max().item()
        log(f"  h, ghost {ghost} vs ghost 1: max |difference| {err:.3e} "
            f"(atol 1e-3) {'ok' if err <= 1e-3 else 'FAIL'}")
        if not err <= 1e-3:
            raise RuntimeError(f"ghost {ghost} and ghost 1 disagree on h")
        result[f"h_ghost{ghost}_vs_ghost1"] = err

    for ghost in (1, 4):
        cfg_b = dataclasses.replace(cfg, ghost=ghost, dtype="bfloat16")
        multi = sw.make_multistep(cfg_b, comm, n_steps, donate=True)
        s = sw.make_first_step(cfg_b, comm)(
            sw.make_init(cfg_b, comm, device=device)())
        s = multi(multi(s))  # eager, then a replay
        finite = all(bool(torch.isfinite(t).all()) for t in s)
        log(f"  bfloat16 ghost {ghost}: {2 * n_steps + 1} steps "
            f"({'finite' if finite else 'NOT finite'}), dtype {s.h.dtype}")
        if not finite or s.h.dtype != torch.bfloat16:
            raise RuntimeError(f"bfloat16 ghost {ghost}: not a finite "
                               f"bfloat16 state")
        del multi, s
    try:
        sw.make_init(dataclasses.replace(cfg, dtype="bfloat16"), comm,
                     device=device)
    except ValueError as exc:
        if "ghost 1 and ghost 4" not in str(exc):
            raise
        log(f"  bfloat16 ghost 2 on the card refused: {exc}")
    else:
        raise RuntimeError("bfloat16 at ghost 2 on the card was not refused")
    return result


# -- multi-rank: a grid of ranks on one card, and an NCCL world ---------


def _op_inputs(dtype, seed, rank):
    """Rank ``rank``'s input of a multi-rank op case, on the CPU."""
    gen = torch.Generator().manual_seed(1000 * seed + rank)
    if dtype == "bool":
        return torch.randint(0, 2, (4, 257), generator=gen).bool()
    if dtype == "int32":
        return torch.randint(-3, 4, (4, 257), generator=gen,
                             dtype=torch.int32)
    return torch.randn((4, 257), generator=gen)


def _grad_case(op):
    """``x -> d/dx sum(op(x) * w)``, ``w`` small integers (the same on
    every device), through the op's backward collectives."""
    def fn(x):
        v = x.clone().requires_grad_()
        y = op(v)
        w = (torch.arange(y.numel(), device=y.device) % 7 - 3.0).reshape(
            y.shape)
        (y * w).sum().backward()
        return v.grad
    return fn


def multirank_op_cases(comm):
    """``(name, dtype, fn)``: every ported op at this comm's ranks, each
    ``fn(x)`` returning its result on ``x``'s device.  ``x`` is
    ``_op_inputs``' (4, 257), whose leading dimension is the world's
    size (rows 0..1 for the grid's row comm ``sub("x")``).  The rooted
    ops run at roots 0 and 3 of the world and 1 of the row; their
    results take each rank's own shape.  The ``grad`` cases run the
    backward collectives, the ``jvp`` case forward mode (the caller
    holds the dual level: one per process, around a local world)."""
    n, r = comm.size, comm.rank()
    ring = [(q, (q + 1) % n) for q in range(n)]
    row = comm.sub("x")
    cases = []
    for name in MULTIRANK_OPS:
        dtypes = (("bool",) if name in ("land", "lor", "lxor") else
                  ("int32",) if name in ("band", "bor", "bxor") else
                  ("int32", "float32"))
        for dtype in dtypes:
            cases.append((f"allreduce {name}", dtype,
                          lambda x, name=name: p_ops.allreduce(
                              x, name, comm=comm)[0]))

    def send_recv(x):
        p_ops.send(x, (r + 1) % n, tag=7 + r, comm=comm)
        st = p_ops.Status()
        y, _ = p_ops.recv(x, (r - 1) % n, p_ops.ANY_TAG, comm=comm,
                          status=st)
        if st.Get_tag() != 7 + (r - 1) % n:
            raise RuntimeError(f"recv's status tag {st.Get_tag()}")
        return y

    def any_source(x):
        p_ops.send(x, (r + 1) % n, tag=11, comm=comm)
        st = p_ops.Status()
        y, _ = p_ops.recv(x, p_ops.ANY_SOURCE, 11, comm=comm, status=st)
        if st.Get_source() != (r - 1) % n:
            raise RuntimeError(f"recv's status source {st.Get_source()}")
        return y

    def barrier(x):
        p_ops.barrier(comm=comm)
        return x.clone()

    shift_x = comm.shift_perm("x", 1, periodic=True)
    shift_y = comm.shift_perm("y", -1, periodic=False)
    cases += [
        ("scan sum", "float32",
         lambda x: p_ops.scan(x, "sum", comm=comm)[0]),
        ("scan max", "int32", lambda x: p_ops.scan(x, "max", comm=comm)[0]),
        ("allgather", "float32", lambda x: p_ops.allgather(x, comm=comm)[0]),
        ("allgather", "bool", lambda x: p_ops.allgather(x, comm=comm)[0]),
        ("sendrecv ring", "float32", lambda x: p_ops.sendrecv(
            x, x, source=ring, dest=ring, comm=comm)[0]),
        ("sendrecv shift_perm x periodic", "float32",
         lambda x: p_ops.sendrecv(x, -x, source=shift_x, dest=shift_x,
                                  comm=comm)[0]),
        ("sendrecv shift_perm y walls", "float32",
         lambda x: p_ops.sendrecv(x, -x, source=shift_y, dest=shift_y,
                                  comm=comm)[0]),
        ("send/recv ANY_TAG", "float32", send_recv),
        ("send/recv ANY_SOURCE", "int32", any_source),
        ("barrier", "int32", barrier),
        ("split allreduce", "float32", lambda x: p_ops.allreduce(
            x, "sum", comm=comm.split(lambda q: q % 2))[0]),
        ("sub x allreduce", "int32", lambda x: p_ops.allreduce(
            x, "prod", comm=comm.sub("x"))[0]),
    ]
    # the other collectives, on the world and on the row comm
    reduce_op = {"float32": "sum", "int32": "max", "bool": "lor"}
    for dtype in ("float32", "int32", "bool"):
        op = reduce_op[dtype]
        for label, c, roots in (("", comm, (0, 3)), (" sub x", row, (1,))):
            k = c.size
            cases += [
                (f"alltoall{label}", dtype,
                 lambda x, c=c, k=k: p_ops.alltoall(x[:k], comm=c)[0]),
                (f"alltoall_multi{label}", dtype,
                 lambda x, c=c, k=k: torch.stack(p_ops.alltoall_multi(
                     [x[:k], x[:k].flip(0)], comm=c)[0])),
                (f"reduce_scatter {op}{label}", dtype,
                 lambda x, c=c, k=k, op=op: p_ops.reduce_scatter(
                     x[:k], op, comm=c)[0]),
            ]
            for root in roots:
                cases += [
                    (f"bcast root {root}{label}", dtype,
                     lambda x, c=c, root=root: p_ops.bcast(x, root,
                                                           comm=c)[0]),
                    (f"gather root {root}{label}", dtype,
                     lambda x, c=c, root=root: p_ops.gather(x, root,
                                                            comm=c)[0]),
                    (f"reduce {op} root {root}{label}", dtype,
                     lambda x, c=c, root=root, op=op: p_ops.reduce(
                         x, op, root, comm=c)[0]),
                    # the root's rows; a template elsewhere
                    (f"scatter root {root}{label}", dtype,
                     lambda x, c=c, k=k, root=root: p_ops.scatter(
                         x[:k] if c.rank() == root else x[0], root,
                         comm=c)[0]),
                ]
    # backward collectives, and forward mode
    cases += [(f"grad {name}", "float32", _grad_case(op)) for name, op in (
        ("allgather", lambda v: p_ops.allgather(v, comm=comm)[0]),
        ("scan sum", lambda v: p_ops.scan(v, "sum", comm=comm)[0]),
        ("alltoall", lambda v: p_ops.alltoall(v, comm=comm)[0]),
        ("reduce_scatter sum",
         lambda v: p_ops.reduce_scatter(v, comm=comm)[0]),
        ("bcast root 3", lambda v: p_ops.bcast(v, 3, comm=comm)[0]),
        ("scatter root 3", lambda v: p_ops.scatter(v, 3, comm=comm)[0]),
        ("sendrecv ring", lambda v: p_ops.sendrecv(
            v, v, source=ring, dest=ring, comm=comm)[0]),
        ("allreduce sum sub x", lambda v: p_ops.allreduce(
            v, "sum", comm=row)[0]),
    )]

    def jvp(x):
        dual = fwAD.make_dual(x, torch.cos(x))
        y = p_ops.sendrecv(p_ops.allreduce(dual, "sum", comm=comm)[0],
                           dual, source=ring, dest=ring, comm=comm)[0]
        y = p_ops.reduce_scatter(y, comm=comm)[0]
        return torch.stack(fwAD.unpack_dual(y)[:2])

    cases.append(("jvp allreduce sum, sendrecv, reduce_scatter sum",
                  "float32", jvp))
    return cases


def run_op_cases(comm, device):
    """Every case of :func:`multirank_op_cases` on this rank's inputs on
    ``device``: ``[(name, dtype, result on the CPU)]``."""
    results = []
    for seed, (name, dtype, fn) in enumerate(multirank_op_cases(comm)):
        got = fn(_op_inputs(dtype, seed, comm.rank()).to(device))
        if got.device.type != torch.device(device).type:
            raise RuntimeError(f"{name} {dtype}: result on {got.device}")
        results.append((name, dtype, got.cpu()))
    return results


# float32 cases that add in the backend's order: held within
# MULTIRANK_FLOAT_TOL of the largest value, every other case exactly
SUMMING = ("sum", "prod", "split", "grad", "jvp")


def hold_op_cases(got, want, rank):
    """Readings ``(case, max |difference|, limit, ok)`` of rank
    ``rank``'s results against the CPU's (rooted ops give each rank its
    own shape): exact, but float sums and products within
    MULTIRANK_FLOAT_TOL of the largest value.  A shape or dtype that
    differs raises, naming the rank and the case."""
    readings = []
    for (name, dtype, g), (_, _, w) in zip(got, want, strict=True):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"rank {rank}: {name} {dtype}: {g.dtype} "
                               f"{tuple(g.shape)}, not {w.dtype} "
                               f"{tuple(w.shape)}")
        err = (g.double() - w.double()).abs().max().item()
        tol = (MULTIRANK_FLOAT_TOL * max(w.abs().max().item(), 1e-30)
               if dtype == "float32" and any(word in name for word in SUMMING)
               else 0.0)
        readings.append((f"{name} {dtype}", err, tol, err <= tol))
    return readings


def multirank_ops_check(comm, device):
    """Each case on CUDA tensors (gloo stages them through host memory)
    against the same case on the CPU copies."""
    return hold_op_cases(run_op_cases(comm, device),
                         run_op_cases(comm, "cpu"), comm.rank())


def report_op_cases(readings):
    """Log rank 0's readings and every failure; raise on a failure."""
    failed = []
    for rank, per_rank in enumerate(readings):
        for name, err, tol, ok in per_rank:
            if rank == 0 or not ok:
                log(f"  rank {rank}: {name} on the card vs the CPU: max |"
                    f"difference| {err:.3e} (limit {tol:g}) "
                    f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"rank {rank} {name}")
    if failed:
        raise RuntimeError(f"multi-rank ops differ on the card: {failed}")
    log(f"  {len(readings[0])} op cases on {len(readings)} ranks, every "
        f"rank: ok")


def multirank_ops_phase(device):
    """The op cases on a 2x2 grid of thread ranks on the one card (a
    local world over gloo), each on CUDA tensors against the CPU;
    returns the number of cases."""
    py, px = MULTIRANK_GRID

    def ops(comm):
        if comm.transport().backend != "gloo":
            raise RuntimeError("a local world runs over gloo")
        return multirank_ops_check(comm, device)

    with fwAD.dual_level():
        readings = distributed.local_world(
            py * px, ops, axes=(("y", "x"), MULTIRANK_GRID), deadline=300.0)
    report_op_cases(readings)
    return len(readings[0])


def baseline_collectives(comm, device, timed):
    """BASELINE.json configs 3 and 4 at their size on this rank of the
    2x2 grid.  Config 3: rank 0's 1024x1024 float32 array broadcast,
    scattered by row blocks from rank 0 (a template elsewhere) and the
    blocks gathered back to rank 0.  Config 4: each rank's own 1024x1024
    float32 array exchanged by alltoall over the world comm (4 blocks of
    256 rows), its row comm and its column comm (2 blocks of 512 rows).
    Returns ``{op: result on the CPU}`` (rooted results in each rank's
    own shape) and, with ``timed``, ``{op: (device ms, bus GB/s)}``:
    CUDA events around each call, the median of BASELINE_REPEATS after
    one warm-up call; bus bytes as nccl-tests counts them (bcast the
    array; scatter, gather and alltoall (k - 1) / k of it)."""
    n, r, side = comm.size, comm.rank(), BASELINE_SIDE
    gen = torch.Generator().manual_seed(2024 + r)
    a = torch.randn((side, side), generator=gen).to(device)
    row, col = comm.sub("x"), comm.sub("y")
    full = p_ops.bcast(a, 0, comm=comm)[0]
    blocks = full.reshape(n, side // n, side)
    mine = p_ops.scatter(blocks if r == 0 else blocks[0], 0, comm=comm)[0]
    ops = {
        "config 3 bcast": (lambda: p_ops.bcast(a, 0, comm=comm)[0], 1),
        "config 3 scatter": (lambda: p_ops.scatter(
            blocks if r == 0 else blocks[0], 0, comm=comm)[0], n),
        "config 3 gather": (lambda: p_ops.gather(mine, 0, comm=comm)[0], n),
    }
    for label, c in (("world", comm), ("sub x", row), ("sub y", col)):
        ops[f"config 4 alltoall {label}"] = (
            lambda c=c: p_ops.alltoall(a.reshape(c.size, -1, side),
                                       comm=c)[0], c.size)
    results = {name: fn().cpu() for name, (fn, _) in ops.items()}
    if r == 0 and not torch.equal(results["config 3 gather"].reshape(
            side, side), a.cpu()):
        raise RuntimeError("config 3: the gathered blocks are not rank 0's "
                           "array")
    if not timed:
        return results, None
    nbytes = side * side * 4
    times = {}
    for name, (fn, k) in ops.items():
        ms = []
        for _ in range(BASELINE_REPEATS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        t = statistics.median(ms)
        moved = nbytes if k == 1 else nbytes * (k - 1) / k
        times[name] = (t, moved / (t * 1e-3) / 1e9)
    return results, times


def hold_baseline(got, want, rank):
    """The configs' results against the CPU world's, exactly (every op
    only moves data)."""
    readings = []
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"rank {rank}: {name}: {g.dtype} "
                               f"{tuple(g.shape)}, not {w.dtype} "
                               f"{tuple(w.shape)}")
        err = (g - w).abs().max().item()
        readings.append((name, err, err == 0.0))
    return readings


def block_kernel_checks(comm, cfg, device):
    """sw_main (both first_step values) and sw_visc on this rank's block
    of the decomposed domain, at the inputs the step gives them
    (:func:`sw_bench_inputs` on ``comm``: the block's shape, its own
    walls and row of ranks), each held to its plain version bit for
    bit.  Returns the block's layout and the readings ``(case, output,
    max_abs_err, exact)``."""
    _, inputs, geometry, iy = sw_bench_inputs(cfg, comm, device)
    readings = []

    def hold(case, names, want, got):
        torch.cuda.synchronize()
        for name, w, g in zip(names, want, got, strict=True):
            readings.append((case, name, (w - g).abs().max().item(),
                             torch.equal(w, g)))

    for first_step in (True, False):
        kw = dict(iy=iy, first_step=first_step, **geometry)
        got = sw_step.sw_main(*inputs, **kw)
        hold(f"sw_main first_step={first_step}", sw.SWState._fields,
             sw_step.sw_main_reference(*inputs, **kw), got)
    u, v = got[1].clone(), got[2].clone()
    for f in (u, v):
        halo_exchange_2d(f, comm, periodic=(False, True), width=cfg.ghost)
    hold("sw_visc", "uv", sw_step.sw_visc_reference(u, v, **geometry),
         sw_step.sw_visc(u, v, **geometry))
    return {"iy": iy, "block": tuple(inputs[0].shape),
            "is_south": geometry["is_south"],
            "is_north": geometry["is_north"], "readings": readings}


def report_block_checks(blocks, cfg):
    """Every rank's block checks: the wall layout of a grid of two rows
    of ranks (south wall alone on row 0, north wall alone on row 1) and
    bit equality; raises on a failure."""
    py, px = MULTIRANK_GRID
    shape = (cfg.ny // py + 2 * cfg.ghost, cfg.nx // px + 2 * cfg.ghost)
    failed = []
    for rank, b in enumerate(blocks):
        layout = (b["block"], b["is_south"], b["is_north"])
        if layout != (shape, b["iy"] == 0, b["iy"] == py - 1) or (
                b["is_south"] and b["is_north"]):
            raise RuntimeError(f"rank {rank}'s block {layout} at iy "
                               f"{b['iy']} is not the 2x2 grid's")
        for case in dict.fromkeys(c for c, *_ in b["readings"]):
            outs = [(name, err, exact)
                    for c, name, err, exact in b["readings"] if c == case]
            bad = [name for name, _, exact in outs if not exact]
            log(f"  rank {rank} (iy {b['iy']}, {b['block']}, south wall "
                f"{b['is_south']}, north wall {b['is_north']}): {case}: "
                f"{len(outs)} outputs, max_abs_err "
                f"{max(err for _, err, _ in outs):.3e} (bit-exact required) "
                f"{'FAIL ' + ','.join(bad) if bad else 'ok'}")
            failed += [f"rank {rank} {case} {name}" for name in bad]
    if failed:
        raise RuntimeError(f"a kernel differs from its plain version on "
                           f"a block of the 2x2 grid: {failed}")


def multirank_solver(comm, cfg, device, num_multisteps, t1):
    """``make_solver`` on this rank's block, run to ``t1``: the gathered
    h, the step count and ms a step."""
    solve = sw.make_solver(cfg, comm, num_multisteps=num_multisteps,
                           device=device)
    state, wall, steps = solve(t1)
    h = sw.gather_global(state.h, comm, ghost=cfg.ghost)
    return {"h": h, "steps": steps, "wall_s": wall,
            "replays": solve.multistep.replays,
            "captured": dict(solve.multistep.captured)}


def multirank_reference(cfg, device, num_multisteps, t1):
    """The one-rank kernel run of the same steps from the same initial
    state (one rank, its chunks CUDA graphs)."""
    ref = multirank_solver(MeshComm(), cfg, device, num_multisteps, t1)
    torch.cuda.synchronize()
    return ref


def hold_decomposed(label, h, ref, cfg):
    """The gathered h against the one-rank run (PATH_TOL, the JAX
    package's decomposition tolerance) and its mass (MASS_RTOL)."""
    err = (h.double() - ref["h"].double()).abs().max().item()
    mean_h = h.double().mean().item()
    ok = err <= PATH_TOL and math.isclose(mean_h, cfg.depth,
                                          rel_tol=MASS_RTOL)
    log(f"  {label}: gathered h {tuple(h.shape)} vs the one-rank kernel "
        f"run: max |difference| {err:.3e} (limit {PATH_TOL:g}); mean h "
        f"{mean_h:.7f} vs depth {cfg.depth} (rtol {MASS_RTOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(h).all():
        raise RuntimeError(f"{label}: the decomposed solver disagrees with "
                           f"one rank or loses mass")
    return err, mean_h


def multirank_phase(cfg, device, kernels, card):
    """A 2x2 grid of ranks on the one card: four threads of this process
    over gloo (a local world), CUDA tensors staged through host memory.
    First every ported op against the same op on the CPU; then each
    rank's sw_main and sw_visc on its block, bit for bit against the
    plain versions; then the solver on the full domain, 1800x900 blocks
    at ghost 2, for
    MULTIRANK_STEPS steps through ``make_solver`` (gloo chunks run
    eagerly), with the launch counts set to 0 just before and read just
    after: sw_main and sw_visc 4 times a step; the gathered h against
    the one-rank kernel run, and its mass."""
    py, px = MULTIRANK_GRID
    n = py * px
    axes = (("y", "x"), MULTIRANK_GRID)
    op_cases = multirank_ops_phase(device)
    report_block_checks(distributed.local_world(
        n, lambda comm: block_kernel_checks(comm, cfg, device), axes=axes,
        deadline=300.0), cfg)

    k, t1 = MULTIRANK_CHUNK, (MULTIRANK_STEPS - 0.5) * cfg.dt
    ref = multirank_reference(cfg, device, k, t1)
    reset_launch_counts()
    runs = distributed.local_world(
        n, lambda comm: multirank_solver(comm, cfg, device, k, t1),
        axes=axes, deadline=600.0)
    launches = launch_counts()
    steps = 1 + k + runs[0]["steps"]  # bootstrap, warm-up chunk, timed
    if steps != MULTIRANK_STEPS or ref["steps"] != runs[0]["steps"]:
        raise RuntimeError(f"{steps} steps run, {MULTIRANK_STEPS} asked")
    for kern in kernels:
        got = launches[kern["name"]]
        log(f"  {kern['name']}: {got} launches in {steps} steps of {n} "
            f"ranks (4 a step: {n * steps}) "
            f"{'ok' if got == n * steps else 'FAIL'}")
        if got != n * steps or any(r["replays"] for r in runs):
            raise RuntimeError(f"{kern['name']} launched {got} times in "
                               f"{steps} steps of {n} ranks")
        kern["launches_multirank"] = got
    for rank, r in enumerate(runs[1:], 1):
        if not torch.equal(r["h"], runs[0]["h"]):
            raise RuntimeError(f"rank {rank} gathered another h")
    err, mean_h = hold_decomposed(f"{py}x{px} local world", runs[0]["h"],
                                  ref, cfg)
    step_ms = max(r["wall_s"] for r in runs) / runs[0]["steps"] * 1e3
    ref_ms = ref["wall_s"] / ref["steps"] * 1e3
    log(f"  {py}x{px} ranks on one card over gloo: {step_ms:.4f} ms a step "
        f"(the slowest rank's {runs[0]['steps']} timed steps; a reading, "
        f"host staging included), one rank {ref_ms:.4f} ms, on {card}")
    return {"grid": MULTIRANK_GRID, "backend": "gloo", "steps": steps,
            "launches": {kern["name"]: kern["launches_multirank"]
                         for kern in kernels},
            "h_max_abs_err": err, "mean_h": mean_h, "step_ms": step_ms,
            "one_rank_step_ms": ref_ms,
            "op_cases": op_cases}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(n, worker_args, cards, timeout_s):
    """Run ``chip_smoke.py <worker_args>`` as ``n`` processes, rank ``r``
    on card ``cards[r]`` (torchrun's environment, a free local port),
    each writing its output to a file of a temporary directory; returns
    each rank's exit code (None if it was ended) and output.  A rank
    that fails, or the world outlasting ``timeout_s``, ends the
    others."""
    port = _free_port()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_world_"))
    procs, files = [], []
    try:
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(cards[rank]), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), NCCL_DEBUG="WARN")
            files.append(open(work / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 *worker_args], env=env, stdout=files[-1],
                stderr=subprocess.STDOUT, text=True))
        end = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end or any(
                    p.poll() not in (None, 0) for p in procs):
                log(f"  ending ranks "
                    f"{[r for r, p in enumerate(procs) if p.poll() is None]}"
                    f" ({'timeout' if time.monotonic() > end else 'a rank failed'})")
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
        outs = [(work / f"rank{r}.log").read_text() for r in range(len(files))]
        shutil.rmtree(work, ignore_errors=True)
    return [p.returncode for p in procs], outs


def nccl_world(n, only_pp=False):
    """The 2x2 solver check over NCCL, one process per card: make_multistep
    as a CUDA graph that holds the NCCL exchanges, then the 64 MB
    allreduce's bus bandwidth, the quick bench, and the transformer: the
    decoder on (dp, tp) = (2, 2) with graphs that hold NCCL, the long
    preset as written on (dp, tp, sp) = (1, 2, 2), ring and Ulysses, and
    the bench's pp mode on (dp, pp) = (1, 4) (``nccl_pp_phase``; alone
    with ``only_pp``, which builds no kernel: none runs on that path).
    Needs ``n`` = 4 cards."""
    have = torch.cuda.device_count()
    if n != MULTIRANK_GRID[0] * MULTIRANK_GRID[1] or have < n:
        raise RuntimeError(f"--nccl-world {n} needs a 2x2 grid on 4 cards; "
                           f"this host has {have}")
    for line in card_lines():
        log(f"card: {line}")
    if not only_pp:
        log("phase build")
        build_phase()
    log(f"phase NCCL world: {n} processes, one per card")
    codes, outs = spawn_world(n, ["--nccl-rank"] + (["pp"] if only_pp
                                                    else []),
                              list(range(n)), NCCL_RANK_TIMEOUT_S + 60.0)
    records = []
    for rank, (code, out) in enumerate(zip(codes, outs)):
        for line in out.splitlines():
            log(f"  [rank {rank}] {line}")
            if line.startswith("{"):
                records.append(json.loads(line))
    if any(codes) or len(records) != n:
        raise RuntimeError(f"the NCCL world failed: exit codes {codes}")
    log(json.dumps({"nccl_world": records}))
    # the bench's pp mode across the four cards: every rank returns the
    # same record (its times the slowest rank's)
    pps = [{k: r["pp"][k] for k in ("float32", "bfloat16")}
           for r in records]
    for name, rec in pps[0].items():
        log(f"the bench's pp mode on {rec['mesh']} over NCCL ({name}): "
            f"{rec['step_ms']:.4f} ms a step (the slowest rank's), "
            f"{rec['value']:.2f} tokens/s, {rec['tokens_per_s_per_card']:.2f}"
            f" a card, peak memory per rank {rec['peak_memory_gb_ranks']} "
            f"GB, loss {rec['loss']:.6f}")
    same_pp = all(p == pps[0] for p in pps[1:])
    trace = records[0]["pp"].get("trace_rank0_float32")
    log(f"the bench's pp mode across {n} cards: every rank returned the "
        f"same record: {'ok' if same_pp else 'FAIL'}; one f32 step traced "
        f"on rank 0: " + (f"busy {trace['busy_ms']:.1f} ms of "
                          f"{trace['span_ms']:.1f}, "
                          f"{ {k: round(v, 2) for k, v in trace['split_ms'].items()} }"
                          if trace else "not measured"))
    if not same_pp:
        raise RuntimeError("the ranks' pp records differ")
    if only_pp:
        return 0
    # the bench across the four cards: one schedule and one record on
    # every rank (its decisions are taken on the slowest rank's time),
    # finite, with its allreduce over the four
    benches = [r["bench"] for r in records]
    lead = benches[0]
    numbers = [x for x in lead.values()
               if isinstance(x, (int, float)) and not isinstance(x, bool)]
    checks = {
        "every rank took the same schedule":
            len({b["ghost"] for b in benches}) == 1,
        "every rank returned the same record":
            all(b == lead for b in benches),
        "rank 0's record is finite":
            all(math.isfinite(x) for x in numbers) and lead["value"] > 0,
        "allreduce_devices is 4": lead.get("allreduce_devices") == n,
    }
    for what, ok in checks.items():
        log(f"bench across {n} cards: {what}: {'ok' if ok else 'FAIL'}")
    log(f"bench across {n} cards (quick): {lead['value']:.1f} cell "
        f"updates/s per card at ghost {lead['ghost']}, allreduce "
        f"{lead.get('allreduce_busbw_gbps')} GB/s bus over "
        f"{lead.get('allreduce_devices')} ranks")
    if not all(checks.values()):
        raise RuntimeError(f"the bench across the world failed: {checks}")
    # the transformer across the four cards: every rank's record holds
    # the slowest rank's times, so they agree
    tfs = [r["transformer"] for r in records]
    lead = tfs[0]
    same = all(t["train"][seq]["step_ms"] == lead["train"][seq]["step_ms"]
               for t in tfs for seq in ("ring", "ulysses"))
    same &= all(t["decode"]["legs"] == lead["decode"]["legs"] for t in tfs)
    for seq in ("ring", "ulysses"):
        t = lead["train"][seq]
        log(f"long preset on {t['mesh']} over NCCL ({seq}): "
            f"{t['step_ms']:.4f} ms a step (the slowest rank's), "
            f"{t['value']:.2f} tokens/s, {t['tokens_per_s_per_card']:.2f} a "
            f"card, MFU {t['mfu_pct']:.2f}%, peak memory per rank "
            f"{t['peak_memory_gb_ranks']} GB")
        trace = t.get("trace")
        log(f"  traced on rank 0: "
            + (f"busy {trace['busy_ms']:.1f} ms of {trace['span_ms']:.1f}, "
               f"{ {k: round(v, 2) for k, v in trace['split_ms'].items()} }"
               if trace else "not measured"))
    for key, leg in lead["decode"]["legs"].items():
        log(f"{key} on {leg['mesh']} over NCCL (graphs): "
            f"{leg['value']:.2f} generated tokens/s, global batch "
            f"{leg['batch']}")
    log(f"the transformer across {n} cards: every rank agrees: "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise RuntimeError("the ranks' transformer records differ")
    return 0


def nccl_rank(only_pp=False):
    """One rank of ``--nccl-world``: before NCCL starts, the one-rank
    reference on its card (its graphs capture with no NCCL thread
    about) and the op cases in a CPU local world of the grid's shape;
    then the same op cases on the card over NCCL, held to the CPU's,
    the world's solver and the bus bandwidth, the bench, the
    transformer, and the bench's pp mode (alone with ``only_pp``)."""
    import faulthandler

    # a rank that hangs prints where every thread is, then ends
    faulthandler.dump_traceback_later(NCCL_RANK_TIMEOUT_S, exit=True)
    rank = int(os.environ["RANK"])
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    if only_pp:
        distributed.initialize("cuda")
        comm = distributed.world_comm()
        print(json.dumps({"rank": rank,
                          "pp": nccl_pp_phase(comm, device, rank)}),
              flush=True)
        distributed.finalize()
        return 0
    cfg = sw.SWConfig().bench_size()
    k, t1 = MULTIRANK_CHUNK, (MULTIRANK_STEPS - 0.5) * cfg.dt
    ref = multirank_reference(cfg, device, k, t1)
    log(f"rank {rank}: one-rank reference run on {device}")
    axes = (("y", "x"), MULTIRANK_GRID)
    n = MULTIRANK_GRID[0] * MULTIRANK_GRID[1]
    with fwAD.dual_level():
        want = distributed.local_world(
            n, lambda c: run_op_cases(c, "cpu"), axes=axes)[rank]
    base_want, _ = distributed.local_world(
        n, lambda c: baseline_collectives(c, "cpu", False), axes=axes)[rank]
    # the decoder's (2, 2) gloo world on this card: the NCCL decode's
    # tokens are held to it
    decode_want = mesh_decode_reference(device)
    log(f"rank {rank}: the (2, 2) gloo decode on {device}")
    distributed.initialize("cuda")
    comm = distributed.world_comm(axes)
    if comm.transport().backend != "nccl":
        raise RuntimeError("the world is not NCCL")
    log(f"rank {rank}: in the NCCL world")
    with fwAD.dual_level():
        op_readings = hold_op_cases(run_op_cases(comm, device), want, rank)
    torch.cuda.synchronize()
    for name, err, tol, ok in op_readings:
        log(f"rank {rank}: {name} over NCCL vs a CPU local world: max |"
            f"difference| {err:.3e} (limit {tol:g}) {'ok' if ok else 'FAIL'}")
    if not all(ok for *_, ok in op_readings):
        raise RuntimeError(f"rank {rank}: op cases over NCCL differ from "
                           f"the CPU's")
    base_got, base_ms = baseline_collectives(comm, device, True)
    base_readings = hold_baseline(base_got, base_want, rank)
    for name, err, ok in base_readings:
        ms, gbps = base_ms[name]
        log(f"rank {rank}: {name} ({BASELINE_SIDE}x{BASELINE_SIDE} float32) "
            f"over NCCL vs a CPU local world: max |difference| {err:.3e} "
            f"(exact required) {'ok' if ok else 'FAIL'}; {ms:.4f} ms of "
            f"device time, {gbps:.2f} GB/s bus")
    if not all(ok for *_, ok in base_readings):
        raise RuntimeError(f"rank {rank}: BASELINE configs 3-4 over NCCL "
                           f"differ from the CPU's")
    reset_launch_counts()
    run = multirank_solver(comm, cfg, device, k, t1)
    torch.cuda.synchronize()
    log(f"rank {rank}: solver run")
    counts = {name: (w.launches, run["replays"], run["captured"].get(name))
              for name, w in (("sw_main", sw_step.sw_main),
                              ("sw_visc", sw_step.sw_visc))}
    steps = 1 + k + run["steps"]
    for name, (eager, replays, captured) in counts.items():
        if captured != k or eager + replays * captured != steps:
            raise RuntimeError(f"rank {rank}: {name} {eager} eager + "
                               f"{replays} x {captured} for {steps} steps")
    err, mean_h = hold_decomposed(f"rank {rank}, NCCL 2x2", run["h"], ref,
                                  cfg)
    step_ms = run["wall_s"] / run["steps"] * 1e3
    busbw = port_bench.allreduce_bandwidth(comm, device)
    log(f"rank {rank}: allreduce timed")
    # the bench across the world: the flagship on the 2x2 grid, per card,
    # and its allreduce leg (its stderr lines come from rank 0)
    bench_rec = port_bench.run_bench(quick=True, device=device, comm=comm)
    log(f"rank {rank}: bench run")
    # the transformer across the four cards: the decoder on (2, 2) with
    # its graphs holding NCCL, then the long preset on (1, 2, 2)
    decode_rec = nccl_decode_phase(comm, device, rank, decode_want)
    train_rec = nccl_train_phase(comm, device, rank)
    pp_rec = nccl_pp_phase(comm, device, rank)
    rec = {"rank": rank, "steps": steps, "launches": counts,
           "h_max_abs_err": err, "mean_h": mean_h, "step_ms": step_ms,
           "cell_updates_per_s_per_card": cfg.ny * cfg.nx / comm.size
           / (step_ms * 1e-3),
           "one_rank_step_ms": ref["wall_s"] / ref["steps"] * 1e3,
           "op_cases": len(op_readings),
           "baseline_ms_busbw": base_ms,
           "allreduce_busbw_gbps": busbw,
           "allreduce_devices": comm.size,
           "allreduce_mb": port_bench.ALLREDUCE_MB,
           "bench": bench_rec,
           "transformer": {"decode": decode_rec, "train": train_rec},
           "pp": pp_rec}
    print(json.dumps(rec), flush=True)
    # the world ends through distributed.finalize (the solver's graph,
    # which holds NCCL work, reset before the groups go); a rank that
    # hangs in it prints where every thread is and ends
    faulthandler.dump_traceback_later(FINALIZE_TIMEOUT_S, exit=True)
    t0 = time.perf_counter()
    distributed.finalize()
    faulthandler.cancel_dump_traceback_later()
    log(f"rank {rank}: finalize ended the world in "
        f"{time.perf_counter() - t0:.3f} s")
    sys.stdout.flush()
    return 0


# -- the proc tier: launcher jobs over the native DCN bridge ---------------


def proc_inputs(rank, size):
    """Rank ``rank``'s inputs of the proc battery, as numpy arrays (the
    JAX package's proc job takes the same ones in the port's tests)."""
    rng = np.random.default_rng(7000 + rank)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "x": f32(5, 3),
        "x64": rng.standard_normal(7),
        "xb16": f32(6),
        "i": rng.integers(-40, 40, (6,)).astype(np.int32),
        "b": rng.random(5) > 0.5,
        "rows": f32(size, 3),
        "rows_i": rng.integers(-40, 40, (size, 2)).astype(np.int32),
        "rows_b": rng.random((size, 3)) > 0.5,
        "full": f32(size, 4),
        "parts": [f32(3), f32(2, 2), f32(4)],
        "a2a": [f32(size, 2), f32(size, 3)],
        "w": f32(5, 3),
    }


def proc_halo_inputs(rank, block):
    """Rank ``rank``'s fields h, u, v of the 2x2 halo exchange (``block``
    rows and columns, ghosts included)."""
    rng = np.random.default_rng(9000 + rank)
    return [rng.standard_normal(block).astype(np.float32) for _ in PROC_FIELDS]


def ghost_strips(arrs, width):
    """The ghost ring of each field: the only cells an exchange writes."""
    w = width
    return {f"{name}_{side}": t for name, a in zip(PROC_FIELDS, arrs)
            for side, t in (("south", a[:w]), ("north", a[-w:]),
                            ("west", a[:, :w]), ("east", a[:, -w:]))}


def proc_user_ops():
    """The battery's user operators: commuting, and not."""
    return {
        "max2": p_ops.Op.create(lambda a, b: torch.maximum(a, b) * 2,
                                name="max2"),
        "lin": p_ops.Op.create(lambda a, b: a * 3 + b, name="lin",
                               commute=False),
    }


def proc_battery(comm, device, halo_block=None):
    """Every op of the proc tier on this rank's ``proc_inputs`` on
    ``device``: ``{case: result on the CPU}``, the same cases in the same
    order on every rank (rooted ops give each rank its own shape).  With
    four ranks and ``halo_block``, also the 2x2 halo exchange of h, u, v
    at ``PROC_GHOST`` on a ProcGridComm (periodic in x, walls in y),
    fused and unfused: each field's ghost ring."""
    from mpi4jax_tpu_torch import tuning
    from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d_batch
    from mpi4jax_tpu_torch.parallel.proc import grid_comm

    n, r = comm.size, comm.rank()
    prev, nxt = (r - 1) % n, (r + 1) % n
    inp = proc_inputs(r, n)
    user = proc_user_ops()
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def keep(name, y):
        if y.device.type != torch.device(device).type:
            raise RuntimeError(f"{name}: result on {y.device}")
        out[name] = y.detach().cpu()

    def status(name, st):
        out[name] = torch.tensor([st.Get_source(), st.Get_tag()],
                                 dtype=torch.int32)

    x, i, b = t(inp["x"]), t(inp["i"]), t(inp["b"])
    for op in ("sum", "prod", "min", "max"):
        keep(f"allreduce_{op}_f32", p_ops.allreduce(x, op, comm=comm)[0])
    for op in ("sum", "band", "bor", "bxor"):
        keep(f"allreduce_{op}_i32", p_ops.allreduce(i, op, comm=comm)[0])
    for op in ("land", "lor", "lxor"):
        keep(f"allreduce_{op}_bool", p_ops.allreduce(b, op, comm=comm)[0])
    keep("allreduce_sum_f64", p_ops.allreduce(t(inp["x64"]), "sum",
                                              comm=comm)[0])
    keep("allreduce_sum_bf16", p_ops.allreduce(
        t(inp["xb16"]).bfloat16(), "sum", comm=comm)[0])
    keep("allreduce_user_max2", p_ops.allreduce(x, user["max2"],
                                                comm=comm)[0])
    keep("allreduce_user_lin", p_ops.allreduce(i, user["lin"], comm=comm)[0])
    keep("scan_sum_f32", p_ops.scan(x, "sum", comm=comm)[0])
    keep("scan_max_i32", p_ops.scan(i, "max", comm=comm)[0])
    keep("scan_user_lin", p_ops.scan(i, user["lin"], comm=comm)[0])
    keep("allgather_f32", p_ops.allgather(x, comm=comm)[0])
    keep("allgather_bool", p_ops.allgather(b, comm=comm)[0])
    rows, rows_i = t(inp["rows"]), t(inp["rows_i"])
    keep("alltoall_f32", p_ops.alltoall(rows, comm=comm)[0])
    keep("alltoall_i32", p_ops.alltoall(rows_i, comm=comm)[0])
    keep("reduce_scatter_sum_f32", p_ops.reduce_scatter(rows, "sum",
                                                        comm=comm)[0])
    keep("reduce_scatter_max_f32", p_ops.reduce_scatter(rows, "max",
                                                        comm=comm)[0])
    keep("reduce_scatter_sum_i32", p_ops.reduce_scatter(rows_i, "sum",
                                                        comm=comm)[0])
    keep("reduce_scatter_sum_bool", p_ops.reduce_scatter(
        t(inp["rows_b"]), "sum", comm=comm)[0])
    keep("reduce_scatter_user_max2", p_ops.reduce_scatter(
        rows, user["max2"], comm=comm)[0])
    for root in sorted({min(1, n - 1), n - 1}):
        keep(f"bcast_root{root}", p_ops.bcast(x, root, comm=comm)[0])
    keep("reduce_sum_root0", p_ops.reduce(x, "sum", 0, comm=comm)[0])
    keep(f"reduce_user_lin_root{n - 1}", p_ops.reduce(
        i, user["lin"], n - 1, comm=comm)[0])
    keep("gather_f32_root0", p_ops.gather(x, 0, comm=comm)[0])
    keep(f"gather_i32_root{n - 1}", p_ops.gather(i, n - 1, comm=comm)[0])
    full = t(inp["full"])
    for root in (0, n - 1):
        keep(f"scatter_root{root}", p_ops.scatter(
            full if r == root else full[0], root, comm=comm)[0])

    # tagged messages: an int partner is this rank's own (MPMD)
    st = p_ops.Status()
    p_ops.send(x, nxt, tag=5, comm=comm)
    keep("recv_tag5", p_ops.recv(x, prev, 5, comm=comm, status=st)[0])
    status("recv_tag5_status", st)
    p_ops.send(x * 2, nxt, tag=9, comm=comm)
    keep("recv_any", p_ops.recv(x, p_ops.ANY_SOURCE, p_ops.ANY_TAG,
                                comm=comm, status=st)[0])
    status("recv_any_status", st)
    p_ops.send(x, nxt, tag=7, comm=comm)
    p_ops.send(i, nxt, tag=8, comm=comm)
    keep("recv_tag8_first", p_ops.recv(i, prev, 8, comm=comm,
                                       status=st)[0])
    keep("recv_tag7_second", p_ops.recv(x, prev, 7, comm=comm)[0])
    keep("sendrecv_ints", p_ops.sendrecv(x, x, prev, nxt, sendtag=3,
                                         comm=comm, status=st)[0])
    status("sendrecv_ints_status", st)
    back = [(q, (q - 1) % n) for q in range(n)]
    keep("sendrecv_pattern", p_ops.sendrecv(rows, rows, back, back,
                                            comm=comm)[0])
    parts = [t(a) for a in inp["parts"]]
    for label, co in (("fused", True), ("unfused", False), ("auto", None)):
        outs, _ = p_ops.sendrecv_multi(
            parts, [p.clone() for p in parts], prev, nxt, sendtag=4,
            comm=comm, status=st, coalesce=co)
        for k, y in enumerate(outs):
            keep(f"sendrecv_multi_{label}_{k}", y)
        status(f"sendrecv_multi_{label}_status", st)
    a2a = [t(a) for a in inp["a2a"]]
    for label, co in (("fused", True), ("unfused", False)):
        outs, _ = p_ops.alltoall_multi(a2a, comm=comm, coalesce=co)
        for k, y in enumerate(outs):
            keep(f"alltoall_multi_{label}_{k}", y)
    p_ops.barrier(comm=comm)

    # gradients across processes
    w = t(inp["w"])
    v = x.clone().requires_grad_()
    y, _ = p_ops.allreduce(v * w, "sum", comm=comm)
    (y * w).sum().backward()
    keep("grad_allreduce_sum", v.grad)
    v = x.clone().requires_grad_()
    z, _ = p_ops.sendrecv(v, torch.zeros_like(v), prev, nxt, comm=comm)
    (z * w).sum().backward()
    keep("grad_sendrecv", v.grad)

    if halo_block is not None and n == 4:
        grid = grid_comm((2, 2))
        for label, threshold in (("fused", 1 << 30), ("unfused", 0)):
            tuning.override_coalesce(threshold)
            fields = [t(a) for a in proc_halo_inputs(r, halo_block)]
            fields, _ = halo_exchange_2d_batch(
                fields, grid, periodic=(False, True), width=PROC_GHOST)
            for k, y in ghost_strips(fields, PROC_GHOST).items():
                keep(f"halo_{label}_{k}", y)
        tuning.override_coalesce(None)
    return out


def async_data(count, rank, salt):
    """Small integers as float32: a SUM of them is exact in any order,
    so a nonblocking result must equal the blocking one bit for bit."""
    rng = np.random.default_rng(1000 * salt + 17 * rank + count)
    return rng.integers(0, 8, size=count).astype(np.float32)


def dp_inputs(rank):
    """The data-parallel step's inputs as numpy arrays: the parameters
    (the same on every rank) of a ``StackParams`` of 4 layers of width
    64 and of an ``MLPParams`` 32 -> 64 -> 8, and rank ``rank``'s
    batches for each (16 and 4 rows).  The JAX package's proc job takes
    the same ones in the port's tests."""
    rng = np.random.default_rng(2024)

    def f32(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d = DP_WIDTH
    stack = {"layers": [(f32((d, d), (2.0 / d) ** 0.5), f32((d,), 0.1))
                        for _ in range(DP_LAYERS)],
             "w_out": f32((d, d), (2.0 / d) ** 0.5)}
    mlp = [f32((32, 64), 0.25), f32((64,), 0.1), f32((64, 8), 0.18),
           f32((8,), 0.1)]
    mine = np.random.default_rng(100 + rank)
    return {"stack": stack, "mlp": mlp,
            "x_stack": mine.standard_normal((16, d)).astype(np.float32),
            "t_stack": np.zeros((16, d), np.float32),
            "x_mlp": mine.standard_normal((4, 32)).astype(np.float32),
            "t_mlp": np.zeros((4, 8), np.float32)}


def dp_params(inp, device):
    """The port's ``(StackParams, MLPParams)`` of ``dp_inputs``."""
    from mpi4jax_tpu_torch.models import train as ttrain

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    stack = ttrain.StackParams(
        layers=tuple((t(w), t(b)) for w, b in inp["stack"]["layers"]),
        w_out=t(inp["stack"]["w_out"]))
    return stack, ttrain.MLPParams(*(t(a) for a in inp["mlp"]))


def proc_async(comm, device):
    """The nonblocking requests and the bucketed gradient sync on
    ``device`` (the JAX package's async matrix, ``tests/proc/
    test_async_ops.py``): ``{case: result on the CPU}``.  Raises where a
    nonblocking result differs from its blocking op, where the two arms
    of ``make_dp_train_step`` differ, or where the request discipline
    does not hold.

    * iallreduce SUM and MAX at 1, 997 and 65537 elements, waited out of
      order; six requests in flight under ``waitall``; an isend/irecv
      ring (explicit source, then ANY_SOURCE with its status);
      ireduce_scatter at a block of 33; ``test`` polled until done, then
      ``wait``; the double wait; a user operator refused; a submit whose
      operand is dropped and collected before its wait;
    * ``make_dp_train_step`` for 3 steps on ``StackParams`` (buckets of
      16K) and ``MLPParams`` (4K), overlap on and off;
    * error feedback with the wire dtype set to bf16
      (``runtime.set_wire_dtype``, ``T4J_WIRE_DTYPE``'s runtime knob) for
      2 steps: each residual equal to ``send - q`` and each synced bucket
      to the blocking allreduce of ``q``;
    * ``assert_requests_drained``."""
    import gc

    from mpi4jax_tpu_torch.models import train as ttrain
    from mpi4jax_tpu_torch.native import runtime
    from mpi4jax_tpu_torch.ops.allreduce import BucketedGradSync, tree_flatten

    n, r = comm.size, comm.rank()
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def keep(name, y):
        if y.device.type != torch.device(device).type:
            raise RuntimeError(f"{name}: result on {y.device}")
        out[name] = y.detach().cpu()

    def same(label, got, want):
        keep(label, got)
        if not same_bits(got.cpu().numpy(), want.cpu().numpy()):
            raise RuntimeError(f"{label}: nonblocking differs from blocking")

    tok = p_ops.create_token()
    for count in (1, 997, 65537):
        a, b = t(async_data(count, r, 1)), t(async_data(count, r, 2))
        ra, tok = p_ops.iallreduce(a, "sum", comm=comm, token=tok)
        rb, tok = p_ops.iallreduce(b, "max", comm=comm, token=tok)
        vb, tok = p_ops.wait(rb, token=tok)  # the second request first
        va, tok = p_ops.wait(ra, token=tok)
        same(f"iallreduce_sum_{count}", va,
             p_ops.allreduce(a, "sum", comm=comm)[0])
        same(f"iallreduce_max_{count}", vb,
             p_ops.allreduce(b, "max", comm=comm)[0])
    reqs = []
    for k in range(6):
        req, tok = p_ops.iallreduce(t(async_data(4096, r, 10 + k)), "sum",
                                    comm=comm, token=tok)
        reqs.append(req)
    vals, tok = p_ops.waitall(iter(reqs), token=tok)
    for k, v in enumerate(vals):
        want = sum(async_data(4096, q, 10 + k) for q in range(n))
        same(f"waitall_{k}", v, torch.from_numpy(want))
    right, left = (r + 1) % n, (r - 1) % n
    rr, tok = p_ops.irecv(t(np.zeros(64, np.float32)), source=left, tag=5,
                          comm=comm, token=tok)
    if runtime.async_pending() != 1 or runtime.async_inflight() > 1:
        raise RuntimeError(f"an irecv parked: {runtime.async_pending()} "
                           f"pending, {runtime.async_inflight()} in flight")
    rs, tok = p_ops.isend(t(np.full(64, r, np.float32)), right, tag=5,
                          comm=comm, token=tok)
    (got, none), tok = p_ops.waitall([rr, rs], token=tok)
    if none is not None:
        raise RuntimeError("the isend's wait returned a value")
    same("ring_irecv", got, torch.full((64,), float(left)))
    rr, tok = p_ops.irecv(t(np.zeros((3, 5), np.int32)), comm=comm, tag=6,
                          token=tok)
    rs, tok = p_ops.isend(t(np.full((3, 5), 10 * r, np.int32)), right,
                          tag=6, comm=comm, token=tok)
    st = p_ops.Status()
    got, tok = p_ops.wait(rr, token=tok, status=st)
    p_ops.wait(rs, token=tok)
    same("ring_irecv_any", got, torch.full((3, 5), 10 * left,
                                           dtype=torch.int32))
    if (st.source, st.tag) != (left, 6):
        raise RuntimeError(f"irecv status {(st.source, st.tag)}, want "
                           f"{(left, 6)}")
    x = t(np.stack([async_data(33, r, 50 + row) for row in range(n)]))
    rrs, tok = p_ops.ireduce_scatter(x, "sum", comm=comm, token=tok)
    same("ireduce_scatter", p_ops.wait(rrs, token=tok)[0],
         p_ops.reduce_scatter(x, "sum", comm=comm)[0])
    y = t(async_data(512, r, 99))
    ry, tok = p_ops.iallreduce(y, "sum", comm=comm, token=tok)
    deadline = time.monotonic() + 30
    while not bool(p_ops.test(ry, token=tok)[0]):
        if time.monotonic() > deadline:
            raise RuntimeError("test never completed")
    same("test_then_wait", p_ops.wait(ry, token=tok)[0],
         p_ops.allreduce(y, "sum", comm=comm)[0])
    try:
        p_ops.wait(ry, token=tok)
        raise RuntimeError("the double wait did not raise")
    except RuntimeError as e:
        if "already-consumed" not in str(e):
            raise
    try:
        p_ops.iallreduce(y, proc_user_ops()["max2"], comm=comm)
        raise RuntimeError("a user operator was submitted")
    except NotImplementedError:
        pass
    # the registry, not the caller, keeps the operand alive
    rg, tok = p_ops.iallreduce(t(async_data(65537, r, 77)), "sum",
                               comm=comm, token=tok)
    gc.collect()
    junk = [t(np.full(65537, -1.0, np.float32)) for _ in range(8)]
    del junk
    want = sum(async_data(65537, q, 77) for q in range(n))
    same("dropped_operand", p_ops.wait(rg, token=tok)[0],
         torch.from_numpy(want))

    inp = dp_inputs(r)
    stack, mlp = dp_params(inp, device)
    for name, params, batch, bucket in (
            ("stack", stack, (t(inp["x_stack"]), t(inp["t_stack"])), 1 << 14),
            ("mlp", mlp, (t(inp["x_mlp"]), t(inp["t_mlp"])), 1 << 12)):
        arms = {}
        for arm in ("on", "off"):
            step = ttrain.make_dp_train_step(comm, overlap=arm == "on",
                                             bucket_bytes=bucket)
            p = params
            for _ in range(DP_STEPS):
                p, loss = step(p, batch)
            leaves = tree_flatten(p)[0]
            arms[arm] = leaves + [loss]
            for k, leaf in enumerate(leaves):
                keep(f"dp_{name}_{arm}_{k}", leaf)
            keep(f"dp_{name}_{arm}_loss", loss)
        if not all(torch.equal(a, b) for a, b in zip(*arms.values())):
            raise RuntimeError(f"make_dp_train_step on {name}: overlap on "
                               "and off differ")

    p_ops.barrier(comm=comm)
    runtime.set_wire_dtype("bf16")
    if runtime.wire_dtype_info()["wire_dtype"] != "bf16":
        raise RuntimeError("the wire dtype did not switch to bf16")
    sync = BucketedGradSync(comm, bucket_bytes=1 << 10, average=False)
    rng = np.random.default_rng(300 + r)
    res = {}
    for k in range(EF_STEPS):
        grads = ttrain.MLPParams(*(t(rng.standard_normal(a.shape)
                                     .astype(np.float32)) for a in inp["mlp"]))
        synced, _, new_res = sync(grads, residuals=res)
        leaves = list(grads)
        got = list(synced)
        for bi, bucket in enumerate(sync._buckets(leaves)):
            send = torch.cat([leaves[i].reshape(-1) for i in bucket["idx"]])
            if bi in res:
                send = send + res[bi]
            q = send.to(torch.bfloat16).float()
            if not torch.equal(new_res[bi], send - q):
                raise RuntimeError(f"step {k} bucket {bi}: the residual is "
                                   "not send - q")
            same(f"ef_{k}_{bi}",
                 torch.cat([got[i].reshape(-1) for i in bucket["idx"]]),
                 p_ops.allreduce(q, "sum", comm=comm)[0])
            keep(f"ef_{k}_{bi}_residual", new_res[bi])
        if tuple(new_res["_world"]) != (0, n):
            raise RuntimeError(f"residual stamp {new_res['_world']}")
        res = new_res
    p_ops.barrier(comm=comm)
    runtime.set_wire_dtype("off")
    p_ops.assert_requests_drained()
    if runtime.async_inflight():
        raise RuntimeError(f"{runtime.async_inflight()} requests in flight "
                           "after every wait")
    return out


def save_results(results, path):
    """``{case: CPU tensor}`` to an ``.npz`` (bfloat16 as its int16
    bits)."""
    np.savez(path, **{k: (v.view(torch.int16) if v.dtype == torch.bfloat16
                          else v).numpy() for k, v in results.items()})


def load_results(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def proc_rank(argv):
    """A rank of a launcher job (``--proc-rank KIND OUT_DIR [NY NX]``):
    ``battery`` writes ``proc_battery``'s results (with the halo at an
    NY x NX block) to ``OUT_DIR/rank<r>.npz``, ``async`` those of
    ``proc_async``, ``serve`` the serving engine's finished list
    (``proc_serve``, phase 15 (c)); ``fail`` is the planted
    failure: rank ``proc_failing_rank(n)`` raises once every rank has
    passed a barrier, while the others wait in an allreduce.  Phase 16's
    ranks: ``recover OUT_DIR TOTAL KILL_RANK KILL_STEP`` (``proc_recover``)
    and ``elastic OUT_DIR STEPS D LAYERS BATCH SAVE_EVERY KILL_RANK
    KILL_STEP`` (``proc_elastic``)."""
    from mpi4jax_tpu_torch import get_default_comm
    from mpi4jax_tpu_torch.launch import rank_device

    torch.set_num_threads(1)
    kind, out_dir, *rest = argv
    comm = get_default_comm()
    if comm.backend != "proc":
        raise RuntimeError("--proc-rank runs under "
                           "python -m mpi4jax_tpu_torch.launch")
    device = rank_device()
    if kind == "battery":
        block = tuple(int(a) for a in rest) if rest else None
        save_results(proc_battery(comm, device, block),
                     pathlib.Path(out_dir) / f"rank{comm.rank()}.npz")
        return 0
    if kind == "async":
        save_results(proc_async(comm, device),
                     pathlib.Path(out_dir) / f"rank{comm.rank()}.npz")
        return 0
    if kind == "serve":
        proc_serve(comm, device, out_dir)
        return 0
    if kind == "recover":
        proc_recover(comm, device, out_dir, *(int(a) for a in rest))
        return 0
    if kind == "elastic":
        proc_elastic(device, out_dir, *(int(a) for a in rest))
        return 0
    if kind == "fail":
        p_ops.barrier(comm=comm)
        if comm.rank() == proc_failing_rank(comm.size):
            raise RuntimeError(f"planted failure on rank {comm.rank()}")
        p_ops.allreduce(torch.ones(4, device=device), "sum", comm=comm)
        raise RuntimeError("the allreduce returned without the failed rank")
    raise ValueError(f"unknown --proc-rank kind {kind!r}")


def proc_failing_rank(n):
    """The rank of an ``n``-rank job that the planted failure kills."""
    return n // 2


def proc_job(n, platform, rank_args, timeout_s):
    """This script as the program of an ``n``-rank launcher job
    (``--proc-rank *rank_args``); (exit code, stdout, stderr,
    seconds)."""
    return launch.run_job(
        n, [pathlib.Path(__file__).resolve(), "--proc-rank", *rank_args],
        platform=platform, timeout=timeout_s)


def proc_battery_job(n, platform, block=None, timeout_s=None,
                     kind="battery"):
    """``proc_battery`` (``kind="async"``: ``proc_async``) in an
    ``n``-rank launcher job; ``{rank: results}`` (numpy) and the job's
    seconds.  A failed job raises with its output."""
    timeout_s = PROC_JOB_TIMEOUT_S if timeout_s is None else timeout_s
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_proc_"))
    try:
        rc, out, err, secs = proc_job(
            n, platform, [kind, work, *(block or ())], timeout_s)
        if rc != 0:
            raise RuntimeError(f"the {n}-rank {platform} {kind} job exited "
                               f"{rc}:\n{out[-3000:]}\n{err[-6000:]}")
        return {r: load_results(work / f"rank{r}.npz")
                for r in range(n)}, secs
    finally:
        shutil.rmtree(work, ignore_errors=True)


def same_bits(a, b):
    """Equal shape, dtype and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def hold_bits(label, got, want):
    """``got`` and ``want`` (``{rank: {case: array}}``) equal bit for bit,
    case by case; returns the number of readings, raises naming every
    case that differs."""
    bad = []
    for rank in sorted(want):
        if set(got[rank]) != set(want[rank]):
            raise RuntimeError(f"{label}: rank {rank} has the cases "
                               f"{sorted(set(got[rank]) ^ set(want[rank]))} "
                               "on one side only")
        bad += [f"rank {rank} {k}" for k in want[rank]
                if not same_bits(got[rank][k], want[rank][k])]
    n = sum(len(v) for v in want.values())
    log(f"  {label}: {n - len(bad)} of {n} readings bit for bit "
        f"{'ok' if not bad else 'FAIL'}")
    if bad:
        raise RuntimeError(f"{label}: {bad}")
    return n


def local_world_halo(block, device):
    """The same exchange in a local world of four gloo thread ranks
    (``halo_exchange_2d_batch`` on a 2x2 MeshComm): ``{rank: {case:
    array}}`` with both labels (a mesh has no framing to choose)."""
    from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d_batch

    def body(comm):
        fields = [torch.from_numpy(a).to(device)
                  for a in proc_halo_inputs(comm.rank(), block)]
        fields, _ = halo_exchange_2d_batch(
            fields, comm, periodic=(False, True), width=PROC_GHOST)
        strips = {k: v.cpu().numpy()
                  for k, v in ghost_strips(fields, PROC_GHOST).items()}
        return {f"halo_{label}_{k}": v for label in ("fused", "unfused")
                for k, v in strips.items()}

    return dict(enumerate(distributed.local_world(
        4, body, axes=(("y", "x"), (2, 2)), deadline=300.0)))


def proc_phase(device, card):
    """The proc tier on the card: launcher jobs of the port over the
    native bridge (built in the build phase).  (a) the battery on CUDA
    tensors staged through host memory, 4 ranks on the one card, equal
    bit for bit to the same battery on CPU tensors in a second job;
    (b) the 2x2 halo exchange of h, u, v at the flagship's per-rank
    block (``PROC_HALO_BLOCK``, ghost 2), fused and unfused, equal bit
    for bit to the same exchange in a local world of four gloo thread
    ranks; (c) a planted failure: the launcher exits nonzero within its
    deadline and names the failing rank; (d) the bench's two proc legs at
    ``--quick`` sizes.  Every job's seconds are printed."""
    n = PROC_RANKS
    native_build.ensure_built()
    log(f"  bridge build: {native_build.build_seconds():.1f} s (g++; "
        f"{native_build.library_dir().name})")
    cuda, cuda_s = proc_battery_job(n, "cuda", PROC_HALO_BLOCK)
    log(f"  {n}-rank battery on CUDA tensors (+ the halo at "
        f"{PROC_HALO_BLOCK[0]}x{PROC_HALO_BLOCK[1]}): {cuda_s:.1f} s")
    cpu, cpu_s = proc_battery_job(n, "cpu", PROC_HALO_BLOCK)
    log(f"  {n}-rank battery on CPU tensors: {cpu_s:.1f} s")
    readings = hold_bits("(a) CUDA battery vs CPU battery", cuda, cpu)
    halo = {r: {k: v for k, v in res.items() if k.startswith("halo_")}
            for r, res in cuda.items()}
    readings += hold_bits("(b) proc halo, fused vs unfused",
                          {r: {k.replace("unfused", "fused"): v
                               for k, v in h.items() if "unfused" in k}
                           for r, h in halo.items()},
                          {r: {k: v for k, v in h.items()
                               if "_fused_" in k} for r, h in halo.items()})
    t0 = time.perf_counter()
    readings += hold_bits("(b) proc halo vs a local world of 4 gloo "
                          "thread ranks", halo,
                          local_world_halo(PROC_HALO_BLOCK, device))
    local_s = time.perf_counter() - t0

    rc, out, err, fail_s = proc_job(n, "cuda", ["fail", "-"],
                                    PROC_FAIL_TIMEOUT_S)
    bad = proc_failing_rank(n)
    named = (f"rank {bad} failed first (RuntimeError: planted failure on "
             f"rank {bad})" in err)
    ok = rc not in (0, 124) and named and fail_s < PROC_FAIL_TIMEOUT_S
    log(f"  (c) planted failure on rank {bad}: launcher exit "
        f"{rc} after {fail_s:.1f} s (deadline {PROC_FAIL_TIMEOUT_S:g} s), "
        f"rank named: {named} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"the planted failure was not reported:\n"
                           f"{err[-4000:]}")
    legs = port_bench.proc_legs(quick=True)
    log(f"  (d) bench proc legs (--quick): {json.dumps(legs)} on {card}")
    for key in port_bench.PROC_KEYS:
        if not legs.get(key, 0) > 0:
            raise RuntimeError(f"the bench's proc leg gave no {key}")

    on_card, async_cuda_s = proc_battery_job(n, "cuda", kind="async")
    log(f"  (e) {n}-rank async job on CUDA tensors: {async_cuda_s:.1f} s")
    on_cpu, async_cpu_s = proc_battery_job(n, "cpu", kind="async")
    log(f"  (e) {n}-rank async job on CPU tensors: {async_cpu_s:.1f} s")

    def exact(res):
        return {r: {k: v for k, v in x.items() if not k.startswith("dp_")}
                for r, x in res.items()}

    readings += hold_bits("(e) requests and error feedback, CUDA job vs CPU "
                          "job", exact(on_card), exact(on_cpu))
    worst = 0.0
    for r in on_cpu:
        for k, want in on_cpu[r].items():
            if k.startswith("dp_"):
                scale = max(float(np.abs(want).max()), 1e-30)
                worst = max(worst, float(np.abs(
                    on_card[r][k].astype(np.float64) - want).max()) / scale)
    ok = worst <= DP_CARD_RTOL
    log(f"  (e) make_dp_train_step (overlap on and off equal in each job), "
        f"CUDA job vs CPU job: largest difference {worst:.3e} of the "
        f"largest value (limit {DP_CARD_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("(e) the dp step on the card differs from the "
                           "CPU's")
    overlap = port_bench.overlap_leg(batches=1)
    log(f"  (f) bench overlap leg (1 timed batch): {json.dumps(overlap)} on "
        f"{card}")
    for key in port_bench.OVERLAP_KEYS:
        if not overlap[key] > 0:
            raise RuntimeError(f"the bench's overlap leg gave no {key}")
    return {"ranks": n, "bridge_build_s": native_build.build_seconds(),
            "battery_cuda_s": cuda_s, "battery_cpu_s": cpu_s,
            "local_world_halo_s": local_s, "fail_s": fail_s,
            "fail_exit": rc, "readings": readings, "bench": legs,
            "async_cuda_s": async_cuda_s, "async_cpu_s": async_cpu_s,
            "dp_card_vs_cpu": worst, "overlap": overlap}


def mlp_mesh_world(device):
    """``make_global_train_step`` and the ZeRO step
    (``make_global_zero_train_step``, momentum 0.9) for ``MLP_STEPS``
    steps each on a ``MLP_MESH`` (dp, tp) local world of gloo thread
    ranks on ``device``, from one seeded set of full parameters and one
    global batch: ``{rank: {case: array}}`` with every rank's parameter
    shards, ZeRO momentum chunks and losses."""
    from mpi4jax_tpu_torch.models import train as ttrain

    d_in, d_hid, d_out, batch = MLP_SIZES
    rng = np.random.default_rng(4242)
    full = [rng.standard_normal((d_in, d_hid)) * (2.0 / d_in) ** 0.5,
            rng.standard_normal(d_hid) * 0.1,
            rng.standard_normal((d_hid, d_out)) * (2.0 / d_hid) ** 0.5,
            rng.standard_normal(d_out) * 0.1]
    x = rng.standard_normal((batch, d_in))
    y = x @ rng.standard_normal((d_in, d_out))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def body(comm):
        cdp, ctp = comm.sub("dp"), comm.sub("tp")
        params = ttrain.shard_params(ttrain.MLPParams(*map(t, full)), ctp)
        out = {}
        plain = ttrain.make_global_train_step(cdp, ctp, lr=MLP_LR)
        zero, init = ttrain.make_global_zero_train_step(cdp, ctp, lr=MLP_LR,
                                                        momentum=0.9)
        p, zp, v = params, params, init(params)
        for k in range(MLP_STEPS):
            p, loss = plain(p, (t(x), t(y)))
            zp, v, zloss = zero(zp, v, (t(x), t(y)))
            out[f"plain_loss_{k}"] = loss
            out[f"zero_loss_{k}"] = zloss
        for name, a, b, c in zip(ttrain.MLPParams._fields, p, zp, v):
            out[f"plain_{name}"], out[f"zero_{name}"] = a, b
            out[f"zero_momentum_{name}"] = c
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    return dict(enumerate(distributed.local_world(
        int(np.prod(MLP_MESH)), body, axes=(("dp", "tp"), MLP_MESH),
        deadline=300.0)))


def mlp_mesh_phase(device, card):
    """Phase 12: the MLP's tensor-parallel and ZeRO steps
    (``models/train.py``) on a (2, 2) local world of gloo thread ranks on
    the card, every rank's parameters, momentum and losses within
    ``DP_CARD_RTOL`` of the same world on the CPU (float32 products
    summed in another order on the card); each world's seconds."""
    t0 = time.perf_counter()
    card_run = mlp_mesh_world(device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_run = mlp_mesh_world(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    worst, bad = 0.0, []
    for r, want in cpu_run.items():
        for k, w in want.items():
            got = card_run[r][k]
            if not np.isfinite(got).all() or got.shape != w.shape:
                bad.append(f"rank {r} {k}")
                continue
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(got.astype(np.float64) - w).max()) / scale
            worst = max(worst, err)
            if err > DP_CARD_RTOL:
                bad.append(f"rank {r} {k} {err:.3e}")
    falls = all(cpu_run[r][f"{s}_loss_{MLP_STEPS - 1}"][0]
                < cpu_run[r][f"{s}_loss_0"][0]
                for r in cpu_run for s in ("plain", "zero"))
    log(f"  {MLP_MESH} world, d_in {MLP_SIZES[0]}, hidden {MLP_SIZES[1]}, "
        f"d_out {MLP_SIZES[2]}, batch {MLP_SIZES[3]}, {MLP_STEPS} steps of "
        f"each: card {card_s:.1f} s, CPU {cpu_s:.1f} s; largest difference "
        f"card vs CPU {worst:.3e} of the largest value (limit "
        f"{DP_CARD_RTOL:g}), losses fall: {falls} "
        f"{'ok' if not bad and falls else 'FAIL'} on {card}")
    if bad or not falls:
        raise RuntimeError(f"phase 12: {bad or 'the losses do not fall'}")
    return {"card_s": card_s, "cpu_s": cpu_s, "card_vs_cpu": worst}


# -- phase 13: the MoE transformer ---------------------------------------


def moe_data(cfg, device, seed, dtype=torch.float32,
             batch=MOE_RUN["batch"], seq=MOE_RUN["seq"]):
    """MoE parameters of ``dtype`` and a batch of tokens with their
    next-token targets, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe.init_params(cfg, generator=gen, dtype=dtype, device=device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device)
    return params, (tokens, torch.roll(tokens, -1, dims=1))


def moe_names():
    return ["embed", *moe.MoEBlockParams._fields, "ln_f", "head"]


def moe_flash_launches(cfg, dtype, device, batch, seq):
    """The flash launches per layer of one MoE training step (no remat):
    one of each kernel of the route ``flash_supported`` picks for the
    attention's operands, or none if it picks the dense path."""
    q = torch.empty((batch, seq, cfg.heads, cfg.head_dim), dtype=dtype,
                    device=device)
    k = torch.empty((batch, seq, cfg.kv_heads, cfg.head_dim), dtype=dtype,
                    device=device)
    want = dict.fromkeys(TRAIN_LAUNCHES, 0)
    if kflash.flash_supported(q, k, k):
        suffix = "_mma" if dtype == torch.bfloat16 else ""
        for part in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            want[part + suffix] = 1
    return want


def moe_with_attention(cfg, attn_impl):
    """``cfg`` with an ``attn_impl`` field (the MoE config has none: the
    dense scaffold reads it with its default, ``"auto"``)."""
    fields = cfg._asdict()
    with_attn = collections.namedtuple("MoEConfigWithAttention",
                                       [*fields, "attn_impl"])
    return with_attn(**fields, attn_impl=attn_impl)


def moe_path(device, dtype, card):
    """Phase 13 (a) in one dtype: the bench's moe model on one card
    through ``make_global_train_step``, one warm-up step and
    ``MOE_TIMED_STEPS`` timed ones, every launch count set to 0 just
    before each and read just after."""
    cfg = MOE_CFG
    batch_size, seq = MOE_RUN["batch"], MOE_RUN["seq"]
    name = str(dtype)[6:]
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    params, batch = moe_data(cfg, device, seed=0, dtype=dtype)
    step = moe.make_global_train_step(*mesh_comms(one), cfg, lr=MOE_LR,
                                      device=device)
    per_layer = moe_flash_launches(cfg, dtype, device, batch_size, seq)
    want = {k: cfg.layers * n for k, n in per_layer.items()}
    route = [k for k, n in per_layer.items() if n]
    log(f"  {name}: flash_supported picks {route or 'no flash kernel'} "
        f"for the attention's [{batch_size}, {seq}, {cfg.heads}, "
        f"{cfg.head_dim}] operands")
    if not route:
        raise RuntimeError(f"the {name} MoE step's attention takes no "
                           f"flash kernel")
    torch.cuda.reset_peak_memory_stats(device)
    (params, loss), warm_s = synced_seconds(lambda: step(params, batch))
    losses = [loss.item()]
    inputs = params
    saved = [t.clone() for t in tfm._leaves(inputs)]
    walls, per_step = [], []
    for _ in range(MOE_TIMED_STEPS):
        reset_launch_counts()
        (params, loss), wall = synced_seconds(lambda: step(params, batch))
        counts = launch_counts()
        per_step.append({k: counts[k] for k in want})
        walls.append(wall)
        losses.append(loss.item())
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    failed = [f"step {i}: {c}" for i, c in enumerate(per_step) if c != want]
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"losses not finite: {losses}")
    if not all(torch.equal(a, b) for a, b in zip(tfm._leaves(inputs),
                                                 saved)):
        failed.append("the step changed its input parameters")
    changed = [(new != old).float().mean().item()
               for new, old in zip(tfm._leaves(params), saved)]
    if not any(changed):
        failed.append("the steps changed no parameter")
    del inputs, saved
    n_params, n_active = moe.active_params(cfg)
    best = min(walls)
    # one more step under torch.profiler: device time by kernel class
    per_kernel, span = device_trace(lambda: step(params, batch))
    trace = None
    if per_kernel:
        split = device_split(per_kernel)
        busy = sum(split.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
        trace = {"busy_ms": busy, "span_ms": span, "split_ms": split,
                 "launches": sum(c for _, c in per_kernel.values()),
                 "idle_share": 1 - busy / (best * 1e3),
                 "top": [(kname[:90], ms, c) for kname, (ms, c) in top]}
        log(f"  {name}: one traced step: device busy {busy:.4f} ms in "
            f"{trace['launches']} launches over a {span:.4f} ms timeline; "
            f"idle share {trace['idle_share']:.4f} of the untraced best "
            f"step; by class { {k: round(v, 4) for k, v in split.items()} }")
        for kname, (ms, c) in top:
            log(f"    {ms:.4f} ms, {c} launches: {kname[:90]}")
    else:
        log(f"  {name}: the profiler recorded no device activity: the "
            f"split is not measured")
    tokens = batch_size * seq
    model_tflops = 6.0 * n_active * tokens / best / 1e12
    log(f"  {name}: {n_params / 1e6:.2f} M parameters, {n_active / 1e6:.2f} "
        f"M active, {cfg.experts} experts; warm-up {warm_s:.3f} s; "
        f"launches per timed step {per_step[0]} (want {want}); losses "
        f"{losses}; share of elements changed per leaf "
        f"{[round(c, 4) for c in changed]}; inputs unchanged")
    log(f"  {name}: step {best * 1e3:.4f} ms (best of {MOE_TIMED_STEPS}; "
        f"all {[round(w * 1e3, 4) for w in walls]}), {tokens / best:.2f} "
        f"tokens/s, {model_tflops:.4f} model TFLOP/s on active parameters "
        f"(6·N_active·tokens); peak memory {peak_gb:.4f} GB; on {card}"
        + (f" FAIL {failed}" if failed else ""))
    if failed:
        raise RuntimeError(f"the {name} MoE path: {failed}")
    return {"step_ms": best * 1e3, "step_ms_all": [w * 1e3 for w in walls],
            "tokens_per_s": tokens / best, "model_tflops_per_sec":
            model_tflops, "params_m": n_params / 1e6,
            "params_active_m": n_active / 1e6, "peak_memory_gb": peak_gb,
            "losses": losses, "warmup_s": warm_s, "trace": trace,
            "launches": {k: sum(c[k] for c in per_step) for k in want},
            "launches_per_step": per_step[0]}


@contextlib.contextmanager
def recorded_routes():
    """The ``(E, cap)`` routing indices of every ``_route`` call inside
    (the MoE layer's, the oracle's), in order."""
    routes = []
    plain = moe._route

    def recording(xt, wr, cfg):
        out = plain(xt, wr, cfg)
        routes.append(out[1].detach().clone())
        return out

    moe._route = recording
    try:
        yield routes
    finally:
        moe._route = plain


def moe_reference_step(params, batch, cfg, dp, sp, lr):
    """One SGD step on ``reference_loss`` (routed per (dp, sp) block, as
    the mesh routes), on one rank: ``(loss [1], new leaves, routes)``."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tfm._leaves(params)]
    with recorded_routes() as routes:
        loss = moe.reference_loss(tfm._from_leaves(leaves, params), *batch,
                                  cfg, dp, sp)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, grads)]
    return loss.detach().reshape(1), new, routes


def moe_readings(loss, leaves, ref_loss, ref_leaves, p0):
    """The loss's relative difference and, per leaf, max|difference| of
    the updated parameters over max|reference update|."""
    out = {"loss": abs(float(loss[0]) - float(ref_loss[0]))
           / abs(float(ref_loss[0]))}
    for name, got, want, start in zip(moe_names(), leaves, ref_leaves, p0):
        got, want = got.detach().float(), want.detach().float()
        scale = float((want - start.float()).abs().max())
        out[name] = float((got - want).abs().max()) / max(scale, 1e-30)
    return out


def moe_check(device):
    """Phase 13 (b): at ``MOE_CHECK_LAYERS`` layers of the moe model in
    f32, one step at lr 1 on the kernel path (the flash kernels, once a
    layer each), on the plain path (their plain versions as the
    attention function) and on ``reference_loss``'s gradient at dp = sp
    = 1: each pair's routes the same (every expert takes the same tokens
    in every layer), and its loss and every updated leaf within
    ``MOE_CHECK_LIMIT``."""
    cfg = MOE_CFG._replace(layers=MOE_CHECK_LAYERS)
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    params, batch = moe_data(cfg, device, seed=1)
    p0 = tfm._leaves(params)
    runs = {}
    for label, attn in (("kernel", cfg),
                        ("plain", moe_with_attention(
                            cfg, plain_train_attention))):
        step = moe.make_global_train_step(*mesh_comms(one), attn,
                                          lr=MOE_CHECK_LR, device=device)
        reset_launch_counts()
        with recorded_routes() as routes:
            new, loss = step(params, batch)
        counts = launch_counts()
        runs[label] = (loss, tfm._leaves(new), routes)
        if label == "kernel":
            want = {k: cfg.layers * n for k, n in moe_flash_launches(
                cfg, torch.float32, device, *batch[0].shape).items()}
            got = {k: counts[k] for k in want}
    runs["reference"] = moe_reference_step(params, batch, cfg, 1, 1,
                                           MOE_CHECK_LR)
    failed = [] if got == want else [f"kernel path launches {got}, want "
                                     f"{want}"]
    out = {"launches": got}
    for a, b in (("kernel", "plain"), ("kernel", "reference"),
                 ("plain", "reference")):
        # the same tokens for each expert in every layer (their order in
        # the expert's slots moves nothing: near-equal probabilities may
        # swap it)
        same = len(runs[a][2]) == len(runs[b][2]) and all(
            torch.equal(x.sort(-1).values, y.sort(-1).values)
            for x, y in zip(runs[a][2], runs[b][2]))
        read = moe_readings(runs[a][0], runs[a][1], runs[b][0], runs[b][1],
                            p0)
        worst = max(read.values())
        ok = same and worst <= MOE_CHECK_LIMIT
        log(f"  {cfg.layers}-layer f32 step, {a} against {b}: routes "
            f"{'equal' if same else 'DIFFER (a flipped near-tie)'}; "
            f"largest reading {worst:.3e} (limit {MOE_CHECK_LIMIT:g}) "
            f"{'ok' if ok else 'FAIL'}")
        log(f"    readings: { {k: f'{v:.2e}' for k, v in read.items()} }")
        out[f"{a}_vs_{b}"] = {"routes_equal": same, "worst": worst,
                              "readings": read}
        if not ok:
            failed.append(f"{a} vs {b}")
    log(f"  kernel path launches {got} (want {want})")
    if failed:
        raise RuntimeError(f"the MoE step held on the card: {failed}")
    return out


def moe_step_summing_experts_over_sp(comm_dp, comm_tp, comm_sp, cfg, lr,
                                     device):
    """A planted fault: the MoE step whose gradient sync takes the
    expert leaves for replicated ones and sums them over sp too (so
    each rank adds its sp peers' experts' gradients into its own)."""
    specs = moe.param_specs("tp", "sp")
    whole = tfm.P(None, None, None, None)
    specs = specs._replace(blocks=specs.blocks._replace(w1e=whole,
                                                        w2e=whole))
    return tfm.make_global_train_step(comm_dp, comm_tp, comm_sp, cfg, lr,
                                      mlp=moe._moe_mlp, specs=specs,
                                      device=device)


def moe_mesh_run(params, batch, cfg, device, lr, fault=False):
    """One MoE step on four thread ranks of the ``MOE_MESH`` local world
    on the card from the full ``params`` (every rank cuts its shards):
    ``(loss, gathered leaves, slowest rank's ms)`` of rank 0, held equal
    on every rank unless the fault is planted."""
    make_step = (moe_step_summing_experts_over_sp if fault
                 else moe.make_global_train_step)

    def body(comm):
        comm_dp, comm_tp, comm_sp = mesh_comms(comm)
        shards = moe.shard_params(params, comm_tp, comm_sp)
        step = make_step(comm_dp, comm_tp, comm_sp, cfg, lr=lr,
                         device=device)
        (shards, loss), wall = synced_seconds(lambda: step(shards, batch))
        full = moe.gather_params(shards, comm_tp, comm_sp)
        return loss, tfm._leaves(full), wall

    runs = distributed.local_world(
        math.prod(MOE_MESH), body, axes=(("dp", "tp", "sp"), MOE_MESH),
        deadline=600.0)
    loss, full, _ = runs[0]
    for rank, (l, f, _) in enumerate(runs[1:] if not fault else [], 1):
        differ = [name for name, a, b in zip(["loss", *moe_names()],
                                             [l, *f], [loss, *full])
                  if not torch.equal(a, b)]
        if differ:
            raise RuntimeError(f"rank {rank} of the MoE mesh holds another "
                               f"{differ} than rank 0")
    return loss, full, max(w for *_, w in runs) * 1e3


def topk_moe_world(device):
    """``topk_moe`` on a 1-D local world of ``MOE_A2A["ranks"]`` gloo
    thread ranks on ``device``, 2 experts a rank (so through
    ``alltoall_multi`` with two parts), each expert scaling its tokens:
    every rank's output and the gradients of ``sum(y²)`` for its tokens
    and scores, on the CPU, from inputs made on the CPU."""
    n, t, d = MOE_A2A["ranks"], MOE_A2A["tokens"], MOE_A2A["d_model"]
    experts, k = MOE_A2A["experts"], MOE_A2A["k"]
    m = experts // n
    gen = torch.Generator().manual_seed(13)
    xs = torch.randn((n, t, d), generator=gen)
    scores = torch.softmax(torch.randn((n, t, experts), generator=gen), -1)
    scales = 1.0 + torch.arange(experts, dtype=torch.float32)

    def body(comm):
        r = comm.rank()
        x = xs[r].to(device).requires_grad_(True)
        sc = scores[r].to(device).requires_grad_(True)
        own = scales[r * m:(r + 1) * m].to(device)
        y, _ = pmoe.topk_moe(x, sc, lambda v: v * own[:, None, None], comm,
                             k=k)
        dx, dsc = torch.autograd.grad((y * y).sum(), (x, sc))
        return [a.detach().cpu() for a in (y, dx, dsc)]

    return distributed.local_world(n, body, axes=(("ep",), (n,)),
                                   deadline=300.0)


def moe_mesh_phase(device, card):
    """Phase 13 (c): the MoE step on the ``MOE_MESH`` local world of four
    gloo thread ranks on the card (``MOE_MESH_CFG``: 8 experts, 2 a sp
    rank), both routings: one f32 step at lr 1 gathered against the
    one-rank ``reference_loss`` step on the same global batch (routed
    per (dp, sp) block), within ``MOE_CHECK_LIMIT``, and the planted
    fault (the expert leaves summed over sp) read beside it, which must
    exceed it; then ``topk_moe`` through ``alltoall_multi`` on CUDA
    tensors against the same world on CPU tensors, within
    ``MULTIRANK_FLOAT_TOL`` of the largest value."""
    cfg = MOE_MESH_CFG
    dp, _, sp = MOE_MESH
    b, s = MOE_MESH_BATCH * dp, MOE_MESH_SEQ * sp
    record, failed = {}, []
    for routing in ("expert_choice", "topk"):
        rcfg = cfg._replace(routing=routing)
        params, batch = moe_data(rcfg, device, seed=5, batch=b, seq=s)
        p0 = tfm._leaves(params)
        ref_loss, ref_new, _ = moe_reference_step(params, batch, rcfg, dp,
                                                  sp, MESH_CHECK_LR)
        for label, fault in (("mesh", False), ("fault_experts_over_sp",
                                               True)):
            loss, full, ms = moe_mesh_run(params, batch, rcfg, device,
                                          MESH_CHECK_LR, fault)
            read = moe_readings(loss, full, ref_loss, ref_new, p0)
            worst = max(read.values())
            ok = worst <= MOE_CHECK_LIMIT
            log(f"  {routing}, {label}: loss {float(loss[0]):.6f} (one rank "
                f"{float(ref_loss[0]):.6f}), the slowest rank {ms:.1f} ms; "
                f"largest reading {worst:.3e} (limit {MOE_CHECK_LIMIT:g}) "
                + ("planted fault: " + ("FAIL (passed)" if ok else "caught")
                   if fault else ("ok" if ok else "FAIL")))
            log(f"    readings: { {k: f'{v:.2e}' for k, v in read.items()} }")
            record[f"{routing}_{label}"] = {"readings": read,
                                            "worst": worst, "ms": ms}
            if ok == fault:
                failed.append(f"{routing} {label}")
        del params, p0, ref_new
    t0 = time.perf_counter()
    card_run = topk_moe_world(device)
    cpu_run = topk_moe_world(torch.device("cpu"))
    worst = 0.0
    for r, (got, want) in enumerate(zip(card_run, cpu_run)):
        for name, g, w in zip(("y", "dx", "dscores"), got, want):
            err = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            worst = max(worst, err)
            if not (err <= MULTIRANK_FLOAT_TOL and torch.isfinite(g).all()):
                failed.append(f"topk_moe rank {r} {name} {err:.3e}")
    log(f"  topk_moe on {MOE_A2A['ranks']} ranks, {MOE_A2A['experts']} "
        f"experts (2 a rank: alltoall_multi of 2 parts), k {MOE_A2A['k']}, "
        f"{MOE_A2A['tokens']} tokens of {MOE_A2A['d_model']} a rank: CUDA "
        f"against CPU, largest difference {worst:.3e} of the largest value "
        f"(limit {MULTIRANK_FLOAT_TOL:g}), both worlds "
        f"{time.perf_counter() - t0:.1f} s; on {card}")
    record["topk_moe_card_vs_cpu"] = worst
    if failed:
        raise RuntimeError(f"the MoE mesh checks failed: {failed}")
    return record


def moe_bench(device, card):
    """Phase 13 (d): the bench's moe mode (``transformer_train.run``
    with ``mode="moe"``) on ``MOE_CFG`` at ``MOE_RUN``'s batch and seq,
    f32 then bf16, at 1 timed batch.  Every launch count is set to 0
    just before the timed batch and read just after, and must be the
    per-layer launches of :func:`moe_flash_launches` times the layers
    and the timed steps; the record's metric is the moe one, without a
    ``remat`` key, its active parameters ``moe.active_params``', and its
    numbers positive and finite.  Returns the records and the counts."""
    cfg = MOE_CFG
    batch_size, seq = MOE_RUN["batch"], MOE_RUN["seq"]
    out = {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        counted = {}

        @contextlib.contextmanager
        def timed(steps):
            reset_launch_counts()
            yield
            counted.update(steps=steps, counts=launch_counts())

        rec = transformer_train.run(
            batch=batch_size, seq=seq, layers=cfg.layers,
            d_model=cfg.d_model, heads=cfg.heads, kv_heads=cfg.kv_heads,
            d_ff=cfg.d_ff, vocab=cfg.vocab, bf16=dtype == torch.bfloat16,
            batches=1, mode="moe", device=device, timed=timed)
        per_layer = moe_flash_launches(cfg, dtype, device, batch_size, seq)
        want = {k: cfg.layers * n * counted["steps"]
                for k, n in per_layer.items()}
        got = {k: counted["counts"][k] for k in want}
        numbers = {k: rec[k] for k in ("value", "step_ms",
                                       "model_tflops_per_sec", "loss")}
        log(f"  {name}: the bench's moe mode: {json.dumps(rec)}; launches "
            f"over its {counted['steps']} timed steps {got}, expected "
            f"{want}; on {card}")
        if got != want:
            failed.append(f"{name} launched {got}, expected {want}")
        if not all(math.isfinite(x) and x > 0 for x in numbers.values()):
            failed.append(f"{name}: a reading is not a positive finite "
                          f"number: {numbers}")
        if (rec["metric"] != "transformer_moe_train_tokens_per_sec"
                or "remat" in rec or rec["mesh"] != [1, 1, 1]
                or rec["params_active_m"]
                != moe.active_params(cfg)[1] / 1e6):
            failed.append(f"{name}: the record is not the moe mode's on "
                          f"one card: {rec}")
        out[name] = dict(rec, launches=got)
    if failed:
        raise RuntimeError(f"the bench's moe mode: {failed}")
    return out


def moe_phase(device, kernels, card):
    """Phase 13: (a) the bench's moe model on one card in f32 and bf16,
    (b) held on the card at 2 layers, (c) across four thread ranks, (d)
    the bench's moe mode on the model of (a)."""
    t0 = time.perf_counter()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        out[str(dtype)[6:]] = moe_path(device, dtype, card)
        torch.cuda.empty_cache()
    for kern in kernels:
        for name in ("float32", "bfloat16"):
            n = out[name]["launches"].get(kern["name"])
            if n is not None:
                kern[f"launches_moe_{name}"] = n
    out["check"] = moe_check(device)
    torch.cuda.empty_cache()
    out["mesh"] = moe_mesh_phase(device, card)
    torch.cuda.empty_cache()
    out["bench"] = moe_bench(device, card)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


# -- phase 14: the pipeline -----------------------------------------------


@contextlib.contextmanager
def exchange_counter():
    """The exchanges made inside (``ops/p2p.py``'s ``move``: a sendrecv's
    forward or its transpose), counted by ``(axes, rank)`` of the comm
    each ran on."""
    counts = collections.Counter()
    lock = threading.Lock()
    plain = p_p2p.move

    def counting(comm, *args, **kwargs):
        with lock:
            counts[comm.axes, comm.rank()] += 1
        return plain(comm, *args, **kwargs)

    p_p2p.move = counting
    try:
        yield counts
    finally:
        p_p2p.move = plain


def pp_exchanges(schedule, n_micro, stages):
    """The exchanges every rank makes in one pp step: GPipe one handoff a
    tick (``M + S - 1`` ticks) and its transpose, 1F1B two plain
    exchanges a tick (``M + 2(S - 1)`` ticks)."""
    if stages == 1:
        return 0
    if schedule == "gpipe":
        return 2 * (n_micro + stages - 1)
    return 2 * (n_micro + 2 * (stages - 1))


@contextlib.contextmanager
def sync_skipping_pp():
    """A planted fault: the pp step's gradient sync leaves the replicated
    leaves (``embed``, ``ln_f``, ``head``) unsummed over pp, so each
    stage keeps its own share of their gradient (stage 0's head never
    trains)."""
    plain = ppt._sync_grads
    one = MeshComm(axes=("pp",), axis_sizes=(1,))
    ppt._sync_grads = lambda grads, comm_dp, comm_pp: plain(grads, comm_dp,
                                                            one)
    try:
        yield
    finally:
        ppt._sync_grads = plain


def pp_identity(owns):
    """Per replicated leaf, whether every rank's (``owns``: each rank's
    ``{name: tensor}``) holds the same bits as rank 0's."""
    return {name: all(torch.equal(own[name], owns[0][name])
                      for own in owns[1:]) for name in owns[0]}


def pp_mesh_run(params, batch, cfg, schedule, device, lr, fault=None):
    """One pp step on four thread ranks of the ``PP_MESH`` local world
    from the full ``params`` (each rank cuts its stage): ``(loss, rank
    0's gathered parameters, the slowest rank's ms, each rank's
    exchanges, pp_identity of the replicated leaves)``."""
    dp, pp = PP_MESH

    def body(comm):
        comm_dp, comm_pp = comm.sub("dp"), comm.sub("pp")
        stage = ppt.shard_params(params, comm_pp)
        step = ppt.make_global_train_step(
            comm_dp, comm_pp, cfg, PP_RUN["micro"], lr=lr,
            schedule=schedule, device=device)
        (new, loss), wall = synced_seconds(lambda: step(stage, batch))
        own = {name: getattr(new, name) for name in ("embed", "ln_f",
                                                     "head")}
        return loss, ppt.gather_params(new, comm_pp), wall, own

    with exchange_counter() as counts, (fault or contextlib.nullcontext)():
        runs = distributed.local_world(
            dp * pp, body, axes=(("dp", "pp"), PP_MESH), deadline=600.0)
    loss, full, _, _ = runs[0]
    exchanges = [counts[("pp",), r] for r in range(pp)]
    return (loss, full, max(r[2] for r in runs) * 1e3, exchanges,
            pp_identity([r[3] for r in runs]))


def pp_mesh_phase(device, card):
    """Phase 14 (b): the pp step on four gloo thread ranks of the card on
    ``PP_MESH``, ``PP_CFG`` in f32 (2 layers a stage), ``PP_RUN``'s batch
    in 4 microbatches: one step at ``MESH_CHECK_LR`` of each schedule
    against the one-rank dense step (``"xla"`` attention) on the same
    batch, the loss and every gathered leaf within ``MESH_TRAIN_LIMIT``
    (``mesh_readings``), every rank's exchanges ``pp_exchanges`` and its
    ``embed``, ``ln_f`` and ``head`` the same bits as every other's; the
    planted fault (``sync_skipping_pp``) read beside them, which must
    exceed the limit."""
    cfg = PP_CFG
    dp, pp = PP_MESH
    b, s = PP_RUN["batch"] * dp, PP_RUN["seq"]
    params, batch = train_data(cfg, device, seed=6, dtype=torch.float32,
                               batch=b, seq=s)
    p0 = tfm._leaves(params)
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    ref_step = tfm.make_global_train_step(*mesh_comms(one), cfg,
                                          lr=MESH_CHECK_LR, device=device)
    (ref_full, ref_loss), ref_s = synced_seconds(
        lambda: ref_step(params, batch))
    log(f"  one rank, the dense step (attention xla, f32): loss "
        f"{float(ref_loss[0]):.6f}, {ref_s * 1e3:.1f} ms")
    record, failed = {"one_rank_ms": ref_s * 1e3}, []
    for name, schedule, fault in (
            ("gpipe", "gpipe", None), ("1f1b", "1f1b", None),
            ("fault_replicated_not_summed_over_pp", "gpipe",
             sync_skipping_pp)):
        loss, full, ms, exchanges, identity = pp_mesh_run(
            params, batch, cfg, schedule, device, MESH_CHECK_LR, fault)
        read = mesh_readings(loss, full, ref_loss, ref_full, p0)
        worst = max(read.values())
        ok = worst <= MESH_TRAIN_LIMIT
        want = pp_exchanges(schedule, PP_RUN["micro"], pp)
        sound = ok and set(exchanges) == {want} and all(identity.values())
        log(f"  {name} (f32): loss {float(loss[0]):.6f}, the slowest rank "
            f"{ms:.1f} ms; largest reading {worst:.3e} (limit "
            f"{MESH_TRAIN_LIMIT:g}); exchanges per rank {exchanges} (want "
            f"{want}); the same embed, ln_f, head on every rank: "
            f"{identity} "
            + ("planted fault: " + ("FAIL (passed)" if ok else "caught")
               if fault else ("ok" if sound else "FAIL")))
        log(f"    readings: { {k: f'{v:.2e}' for k, v in read.items()} }")
        record[name] = {"readings": read, "worst": worst, "ms": ms,
                        "exchanges": exchanges, "identity": identity}
        if (ok if fault else not sound):
            failed.append(name)
        del full
    log(f"  four thread ranks on one card over gloo (a correctness rig; "
        f"times are readings, host staging included), on {card}")
    if failed:
        raise RuntimeError(f"the pp mesh checks failed: {failed}")
    return record


def pp_bench(device, card):
    """Phase 14 (a): the bench's pp mode (``transformer_train.run`` with
    ``mode="pp"``) at its defaults (``PP_CFG``, ``PP_RUN``: one stage,
    GPipe over 4 microbatches) in f32 then bf16, one timed batch, every
    launch count set to 0 just before it and read just after: no flash
    kernel runs (the stage's attention is ``"xla"``, as in JAX).  The
    record is the pp mode's, its numbers positive and finite; then one
    more step under torch.profiler, device ms by kernel class."""
    cfg = PP_CFG
    out, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        counted = {}

        @contextlib.contextmanager
        def timed(steps):
            reset_launch_counts()
            yield
            counted.update(steps=steps, counts=launch_counts())

        torch.cuda.empty_cache()
        rec = transformer_train.run(
            batch=PP_RUN["batch"], seq=PP_RUN["seq"], layers=cfg.layers,
            d_model=cfg.d_model, heads=cfg.heads, kv_heads=cfg.kv_heads,
            d_ff=cfg.d_ff, vocab=cfg.vocab, bf16=dtype == torch.bfloat16,
            batches=1, mode="pp", micro=PP_RUN["micro"], device=device,
            timed=timed)
        flash = {k: n for k, n in counted["counts"].items()
                 if k.startswith("flash")}
        numbers = {k: rec[k] for k in ("value", "step_ms",
                                       "model_tflops_per_sec",
                                       "peak_memory_gb", "loss")}
        if any(flash.values()):
            failed.append(f"{name}: flash launches {flash}")
        if not all(math.isfinite(x) and x > 0 for x in numbers.values()):
            failed.append(f"{name}: a reading is not a positive finite "
                          f"number: {numbers}")
        if (rec["metric"] != "transformer_pp_train_tokens_per_sec"
                or "remat" in rec or rec["mesh"] != [1, 1]
                or rec["n_micro"] != PP_RUN["micro"]):
            failed.append(f"{name}: not the pp mode's record on one card")
        # one more step under the profiler: device time by kernel class
        one = MeshComm(axes=("dp", "pp"), axis_sizes=(1, 1))
        params, batch = train_data(cfg, device, seed=0, dtype=dtype,
                                   batch=PP_RUN["batch"], seq=PP_RUN["seq"])
        step = ppt.make_global_train_step(
            one.sub("dp"), one.sub("pp"), cfg, PP_RUN["micro"], lr=TRAIN_LR,
            device=device)
        step(params, batch)
        per_kernel, span = device_trace(lambda: step(params, batch))
        trace = None
        if per_kernel:
            split = device_split(per_kernel)
            busy = sum(split.values())
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
            trace = {"busy_ms": busy, "span_ms": span, "split_ms": split,
                     "launches": sum(c for _, c in per_kernel.values()),
                     "idle_share": 1 - busy / rec["step_ms"],
                     "top": [(k[:90], ms, c) for k, (ms, c) in top]}
        del params, step
        log(f"  {name}: the bench's pp mode: step {rec['step_ms']:.4f} ms, "
            f"{rec['value']:.2f} tokens/s, {rec['model_tflops_per_sec']:.4f}"
            f" model TFLOP/s, peak memory {rec['peak_memory_gb']:.4f} GB; "
            f"flash launches over its {counted['steps']} timed steps "
            f"{flash}; on {card}" + (f" FAIL {failed}" if failed else ""))
        log(f"  {name}: {json.dumps(rec)}")
        if trace:
            log(f"  {name}: one traced step: device busy "
                f"{trace['busy_ms']:.4f} ms in {trace['launches']} launches "
                f"over a {span:.4f} ms timeline; idle share "
                f"{trace['idle_share']:.4f} of the bench's step; by class "
                f"{ {k: round(v, 4) for k, v in trace['split_ms'].items()} }")
            for kname, ms, c in trace["top"]:
                log(f"    {ms:.4f} ms, {c} launches: {kname}")
        else:
            log(f"  {name}: the profiler recorded no device activity: the "
                f"split is not measured")
        out[name] = dict(rec, launches=flash, trace=trace)
    if failed:
        raise RuntimeError(f"the bench's pp mode: {failed}")
    return out


def pp_memory(device, card):
    """Phase 14 (c): the one-card pp step (``PP_CFG``, ``PP_RUN``'s batch)
    in bf16 at ``PP_MEMORY_MICRO`` microbatches, each schedule's first
    step with the peak memory statistics reset just before it: 1F1B,
    which holds one microbatch's graph (its logits included), must
    peak lower than GPipe, which holds every microbatch's."""
    cfg = PP_CFG
    one = MeshComm(axes=("dp", "pp"), axis_sizes=(1, 1))
    params, batch = train_data(cfg, device, seed=7, dtype=torch.bfloat16,
                               batch=PP_RUN["batch"], seq=PP_RUN["seq"])
    out = {}
    for schedule in ppt.SCHEDULES:
        step = ppt.make_global_train_step(
            one.sub("dp"), one.sub("pp"), cfg, PP_MEMORY_MICRO, lr=TRAIN_LR,
            schedule=schedule, device=device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        (new, loss), wall = synced_seconds(lambda: step(params, batch))
        peak = torch.cuda.max_memory_allocated(device)
        out[schedule] = {"peak_gb": peak / 1e9,
                         "above_held_gb": (peak - held) / 1e9,
                         "ms": wall * 1e3, "loss": float(loss[0])}
        del new, loss
        log(f"  {schedule} (bf16, {PP_MEMORY_MICRO} microbatches of "
            f"{PP_RUN['batch'] // PP_MEMORY_MICRO}): peak "
            f"{peak / 1e9:.4f} GB ({(peak - held) / 1e9:.4f} above the "
            f"{held / 1e9:.4f} GB held before the step), first step "
            f"{wall * 1e3:.1f} ms, loss {out[schedule]['loss']:.6f}; on "
            f"{card}")
    ok = (out["1f1b"]["peak_gb"] < out["gpipe"]["peak_gb"]
          and all(math.isfinite(r["loss"]) for r in out.values()))
    log(f"  1F1B peaks below GPipe: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"the pp schedules' memory: {out}")
    return out


def pp_phase(device, kernels, card):
    """Phase 14: (a) the bench's pp mode on one card in f32 and bf16, no
    flash launch; (b) both schedules across four thread ranks against
    the one-rank step, and the planted fault; (c) 1F1B against GPipe in
    memory."""
    t0 = time.perf_counter()
    out = {"bench": pp_bench(device, card)}
    for kern in kernels:
        kern["launches_pp"] = sum(out["bench"][name]["launches"].get(
            kern["name"], 0) for name in ("float32", "bfloat16"))
    torch.cuda.empty_cache()
    out["mesh"] = pp_mesh_phase(device, card)
    torch.cuda.empty_cache()
    out["memory"] = pp_memory(device, card)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 14: {out['seconds']:.1f} s")
    return out


# -- phase 15: serving ----------------------------------------------------


def serve_params(cfg, device):
    """The served model's f32 parameters from a seeded CPU generator
    (the same on every rank of a job), on ``device``."""
    return tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device=device)


def serve_requests(run, vocab):
    """``run["requests"]`` requests of the port's ``LoadGen`` (seed
    ``run["seed"]``, prompt lengths and ``max_new`` uniform over
    ``run["prompt"]`` and ``run["new"]``), every one arriving at t = 0."""
    gen = serving.LoadGen(seed=run["seed"], rate_rps=1.0,
                          prompt_len=("uniform", *run["prompt"]),
                          max_new=("uniform", *run["new"]), vocab=vocab)
    return [serving.Request(r.rid, r.prompt, r.max_new, 0.0)
            for r in gen.take(run["requests"])]


def serve_lengths(req, max_len):
    """A response's length: the prompt and its continuation, clamped by
    the slot's ``max_len`` budget."""
    return req.prompt_len + min(req.max_new, max_len - req.prompt_len)


def serve_drive(engine, reqs, stop=False):
    """Offer ``reqs`` at the start of the clock (milliseconds since the
    call) and step the leader until every request finished (then, with
    ``stop``, the stop plan that ends the followers' loop); the
    accounting is checked.  Returns the wall seconds, the steps and the
    occupancy after each step."""
    t0 = time.perf_counter()

    def now():
        return (time.perf_counter() - t0) * 1e3

    for req in reqs:
        engine.offer(req, now())
    occupancy = []
    while not engine.sched.idle():
        engine.step(now())
        occupancy.append(engine.stats.occupancy)
    if stop:
        engine.stop(now())
    engine._sync()
    engine.sched.check_accounting()
    return {"wall_s": time.perf_counter() - t0, "steps": len(occupancy),
            "occupancy": occupancy}


@torch.no_grad()
def oracle_logits(params, tokens, cfg):
    """The unsharded model's logits at the last of ``tokens`` ([1, n]):
    ``reference_greedy_decode``'s forward."""
    x = params.embed[tokens]
    for i in range(cfg.layers):
        x = tfm.dense_layer(x, tfm._layer(params.blocks, i), cfg)
    return tfm._rmsnorm(x[:, -1], params.ln_f, cfg.eps) @ params.head


def serve_oracle(params, cfg, reqs, max_len, device):
    """Each request's response by ``reference_greedy_decode`` on
    ``device``: ``{rid: tokens}``."""
    return {r.rid: tuple(tfm.reference_greedy_decode(
        params, torch.tensor([r.prompt], device=device), cfg,
        serve_lengths(r, max_len))[0].tolist()) for r in reqs}


def hold_responses(finished, reqs, refs, params, cfg, max_len, limit):
    """The engine's responses against the oracle's.  A response may
    depart from the oracle's only where the oracle's top two logits lie
    within ``limit`` of each other: the engine's batched products and
    the oracle's are different cuBLAS calls, so a near tie may flip.
    Returns ``{"equal", "departed": [(rid, index, gap)], "bad": [...]}``,
    ``bad`` the departures at a gap of ``limit`` or more and the
    responses of the wrong length."""
    by_rid = {r.rid: r for r in reqs}
    out = {"equal": 0, "departed": [], "bad": []}
    for rid, toks in finished:
        req, ref = by_rid[rid], refs[rid]
        if len(toks) != serve_lengths(req, max_len) or \
                toks[:req.prompt_len] != req.prompt:
            out["bad"].append((rid, "length or prompt", len(toks)))
            continue
        j = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                 None)
        if j is None:
            out["equal"] += 1
            continue
        prefix = torch.tensor([ref[:j]], device=params.embed.device)
        top2 = torch.topk(oracle_logits(params, prefix, cfg)[0], 2).values
        gap = float(top2[0] - top2[1])
        out["departed"].append((rid, j, gap))
        if not gap < limit:
            out["bad"].append((rid, j, gap))
    return out


@contextlib.contextmanager
def slot_step_fault():
    """Phase 15 (b)'s planted fault: the slot step's attention with every
    row at slot 0's position (each row still writes its own K/V)."""
    sound = serving_engine._slot_attention

    def at_slot_0(q, k, v, pos):
        return sound(q, k, v, pos[:1].expand(pos.shape[0]))

    serving_engine._slot_attention = at_slot_0
    try:
        yield
    finally:
        serving_engine._slot_attention = sound


def serve_warmup(engine, run):
    """Every prefill bucket of ``run``'s prompt range and the decode once,
    outside the measured drive; the engine's stats start afresh."""
    buckets = sorted({engine._prefill_bucket(p)
                      for p in range(run["prompt"][0], run["prompt"][1] + 1)})
    warm = [serving.Request(-1 - i, tuple(range(1, min(b, run["max_len"]
                                                        - 2) + 1)), 3, 0.0)
            for i, b in enumerate(buckets)]
    serve_drive(engine, warm)
    engine.finished.clear()
    engine.reconfigure("off")
    return buckets


def serve_one_card(device, card, run=None, cfg=None, limit=None,
                   open_loop=None):
    """Phase 15 (a) and (b): the engine on one card (a ``SelfComm``) at
    ``SERVE_RUN``, its responses held to the oracle under the tie rule,
    its timings; one open-loop window under admission; then the planted
    fault, which the same check must catch far above the limit."""
    run, cfg = run or SERVE_RUN, cfg or SERVE_CFG
    limit = SERVE_TIE_LIMIT if limit is None else limit
    open_loop = open_loop or SERVE_OPEN
    params = serve_params(cfg, device)

    def engine():
        return serving_engine.ServingEngine(
            SelfComm(), cfg, params, max_len=run["max_len"],
            max_batch=run["max_batch"], admit="off", markers=True,
            device=device)

    eng = engine()
    buckets = serve_warmup(eng, run)
    reqs = serve_requests(run, cfg.vocab)
    reset_launch_counts()
    drive = serve_drive(eng, reqs)
    counts = launch_counts()
    flash = {k: n for k, n in counts.items() if k.startswith("flash")}
    snap = eng.stats.snapshot()
    finished = list(eng.finished)
    t0 = time.perf_counter()
    refs = serve_oracle(params, cfg, reqs, run["max_len"], device)
    oracle_s = time.perf_counter() - t0
    held = hold_responses(finished, reqs, refs, params, cfg, run["max_len"],
                          limit)
    generated = sum(len(t) - reqs[rid].prompt_len for rid, t in finished)
    failed = []
    if sorted(rid for rid, _ in finished) != [r.rid for r in reqs] or \
            (snap["submitted"], snap["completed"], snap["shed"]) != (
                len(reqs), len(reqs), 0):
        failed.append(f"accounting: {len(finished)} finished, {snap}")
    if held["bad"]:
        failed.append(f"responses off the oracle: {held['bad']}")
    if any(flash.values()):
        failed.append(f"flash launches {flash}")

    # the step's and the prefills' device times (CUDA events)
    pos = torch.arange(run["max_batch"], device=device) * (
        run["max_len"] // run["max_batch"]) + run["max_len"] // run[
            "max_batch"] - 1
    last = torch.zeros_like(pos)

    def slot_step():
        return serving_engine._decode_step_slots(
            eng.params, eng.cache, last, pos, cfg, eng.comm, eng.hq_l,
            eng.hk_l)

    with torch.no_grad():
        step_ms = time_ms(slot_step, n=20, repeats=5, warmup=3)
        # one slot step under the profiler: its device work and launches
        per_kernel, span = device_trace(slot_step)
        prefill_ms = {}
        for b in buckets:
            padded = torch.zeros((1, b), dtype=torch.int64, device=device)
            prefill_ms[b] = time_ms(lambda: eng._prefill(padded, 0, b),
                                    n=5, repeats=3, warmup=1)
    out = {"requests": len(reqs), "wall_s": drive["wall_s"],
           "steps": drive["steps"], "generated": generated,
           "tokens_per_s": generated / drive["wall_s"],
           "mean_occupancy": statistics.fmean(drive["occupancy"]),
           "latency_p50_ms": snap["latency_p50_ms"],
           "latency_p99_ms": snap["latency_p99_ms"],
           "first_token_p50_ms": snap["first_token_p50_ms"],
           "first_token_p99_ms": snap["first_token_p99_ms"],
           "decode_step_ms": step_ms, "prefill_ms": prefill_ms,
           "step_trace": None,
           "flash_launches": flash, "launches": counts,
           "equal": held["equal"], "departed": held["departed"],
           "oracle_s": oracle_s, "tie_limit": limit}
    log(f"  (a) {len(reqs)} requests, max_batch {run['max_batch']}, max_len "
        f"{run['max_len']}: {drive['wall_s']:.4f} s wall, {generated} "
        f"tokens generated, {out['tokens_per_s']:.2f} tokens/s, "
        f"{drive['steps']} steps, mean occupancy "
        f"{out['mean_occupancy']:.4f} of {run['max_batch']}; latency p50 "
        f"{snap['latency_p50_ms']:.4f} p99 {snap['latency_p99_ms']:.4f} ms, "
        f"first token p50 {snap['first_token_p50_ms']:.4f} p99 "
        f"{snap['first_token_p99_ms']:.4f} ms; on {card}")
    log(f"  (a) decode step over {run['max_batch']} slots "
        f"{step_ms:.4f} ms (CUDA events); prefill ms by bucket "
        f"{ {b: round(ms, 4) for b, ms in prefill_ms.items()} }; flash "
        f"launches {flash}")
    if per_kernel:
        busy = sum(ms for ms, _ in per_kernel.values())
        trace = out["step_trace"] = {
            "busy_ms": busy, "span_ms": span,
            "launches": sum(c for _, c in per_kernel.values()),
            "idle_share": 1 - busy / step_ms,
            "split_ms": device_split(per_kernel)}
        log(f"  (a) one traced slot step: device busy {busy:.4f} ms in "
            f"{trace['launches']} launches over a {span:.4f} ms timeline; "
            f"idle share {trace['idle_share']:.4f} of the timed step; by "
            f"class { {k: round(v, 4) for k, v in trace['split_ms'].items()} }")
    else:
        log("  (a) the profiler recorded no device activity: the slot "
            "step's split is not measured")
    log(f"  (a) responses against reference_greedy_decode ({oracle_s:.1f} "
        f"s on {device}): {held['equal']} equal, {len(held['departed'])} "
        f"departing at a near tie {held['departed']} (limit: a top-two "
        f"gap under {limit:g}) {'FAIL ' + str(failed) if failed else 'ok'}")

    # one open-loop window: admission on, an SLO, arrivals that overload
    # the slots (benchmarks/serving.py's window)
    args = argparse.Namespace(
        slo=open_loop["slo_ms"], rate_limit=0.0, seed=open_loop["seed"],
        rate=open_loop["rate"], prompt=run["prompt"], new=run["new"],
        vocab=cfg.vocab, duration=open_loop["seconds"])
    window_stats = serving.ServingStats(slo_ms=open_loop["slo_ms"],
                                        max_batch=run["max_batch"],
                                        admit_mode="on")
    info = serving_bench._window(eng, args, "on", {"on": window_stats}, 0)
    eng.sched.check_accounting()
    w = window_stats.snapshot()
    if w["submitted"] != w["completed"] + w["shed"] or \
            w["submitted"] != info["offered"]:
        failed.append(f"open-loop accounting: {info}, {w}")
    eng.stop()
    est = eng.ctrl.estimator
    out["open_loop"] = {"offered": info["offered"], "wall_s": info["wall_s"],
                        "estimator_step_ms": est.step_ms,
                        "estimator_prefill_ms_per_tok":
                            est.prefill_ms_per_tok,
                        **{k: w[k] for k in (
                            "completed", "shed", "shed_by_reason",
                            "slo_attainment", "latency_p50_ms",
                            "latency_p99_ms")}}
    log(f"  (a) open loop, admission on, SLO {open_loop['slo_ms']:g} ms, "
        f"{open_loop['rate']:g} requests/s for {open_loop['seconds']:g} s: "
        f"{info['offered']} offered, {w['completed']} completed, "
        f"{w['shed']} shed {w['shed_by_reason']}, SLO attainment "
        f"{w['slo_attainment']}, p99 {w['latency_p99_ms']} ms, "
        f"{info['wall_s']:.4f} s wall; the estimator learned a "
        f"{est.step_ms:.4f} ms step and {est.prefill_ms_per_tok:.5f} ms "
        f"a prompt token; on {card}")
    del eng

    with slot_step_fault():
        bad = engine()
        serve_drive(bad, reqs=serve_requests(run, cfg.vocab))
    fault = hold_responses(bad.finished, reqs, refs, params, cfg,
                           run["max_len"], limit)
    worst = max((g for _, _, g in fault["departed"]), default=0.0)
    caught = bool(fault["bad"]) and worst >= 10 * limit
    log(f"  (b) planted fault (every row attends at slot 0's position): "
        f"{len(fault['departed'])} of {len(reqs)} responses depart, "
        f"largest top-two gap at a departure {worst:.4f} ({worst / limit:.0f}"
        f" x the limit) {'caught' if caught else 'NOT CAUGHT'}")
    if not caught:
        failed.append(f"the planted fault passed: {fault}")
    out["fault"] = {"departed": len(fault["departed"]), "worst_gap": worst}
    if failed:
        raise RuntimeError(f"phase 15 (a)/(b): {failed}")
    return out


def proc_serve(comm, device, out_dir):
    """Phase 15 (c)'s rank: the engine over the job's proc world at
    ``SERVE_PROC`` on ``SERVE_CFG`` (tp = the world), its tensors on
    ``device`` (staged through host memory across ranks); every rank
    writes its finished list to ``OUT_DIR/rank<r>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    run = SERVE_PROC
    params = serve_params(SERVE_CFG, "cpu")
    eng = serving_engine.ServingEngine(
        comm, SERVE_CFG, params, max_len=run["max_len"],
        max_batch=run["max_batch"], admit="off", markers=True, device=device)
    with torch.no_grad():
        if eng.is_leader:
            serve_drive(eng, serve_requests(run, SERVE_CFG.vocab), stop=True)
        else:
            eng.run_follower()
    out = {"finished": eng.finished, "snapshot": eng.stats.snapshot()}
    (pathlib.Path(out_dir) / f"rank{comm.rank()}.json").write_text(
        json.dumps(out))


def serve_proc_phase(device, card, limit=None):
    """Phase 15 (c): ``SERVE_PROC["ranks"]`` ranks of a ``--serve``
    launcher job on the card: both ranks' finished lists equal, and
    held to the oracle as in (a)."""
    limit = SERVE_TIE_LIMIT if limit is None else limit
    run, n = SERVE_PROC, SERVE_PROC["ranks"]
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        rc, out, err, secs = launch.run_job(
            n, [pathlib.Path(__file__).resolve(), "--proc-rank", "serve",
                work], platform=device.type, timeout=SERVE_PROC_TIMEOUT_S,
            flags=("--serve",))
        if rc != 0:
            raise RuntimeError(f"the {n}-rank serve job exited {rc}:\n"
                               f"{out[-3000:]}\n{err[-6000:]}")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lists = [[(rid, tuple(t)) for rid, t in r["finished"]] for r in ranks]
    reqs = serve_requests(run, SERVE_CFG.vocab)
    params = serve_params(SERVE_CFG, device)
    refs = serve_oracle(params, SERVE_CFG, reqs, run["max_len"], device)
    held = hold_responses(lists[0], reqs, refs, params, SERVE_CFG,
                          run["max_len"], limit)
    agree = all(lst == lists[0] for lst in lists)
    ok = agree and len(lists[0]) == len(reqs) and not held["bad"]
    log(f"  (c) {n}-rank --serve job (tp {n}, {len(reqs)} requests, prompts "
        f"{run['prompt'][0]}-{run['prompt'][1]}, max_batch "
        f"{run['max_batch']}): {secs:.1f} s; the ranks' finished lists "
        f"{'equal' if agree else 'DIFFER'}; {held['equal']} responses equal "
        f"to the oracle, departing at a near tie {held['departed']}; on "
        f"{card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"phase 15 (c): {held}, agree={agree}")
    return {"job_s": secs, "ranks": n, "equal": held["equal"],
            "departed": held["departed"],
            "leader": ranks[0]["snapshot"]}


def serve_bench(card):
    """Phase 15 (d): the bench's serving SLO leg (``bench.serving_leg``,
    the root bench's ``proc_serving``): an 8-rank launcher job on the
    card; its seven keys present and finite."""
    keys = port_bench.serving_leg()
    log(f"  (d) bench serving leg: {json.dumps(keys)} on {card}")
    bad = [k for k in port_bench.SERVING_KEYS
           if not (isinstance(keys.get(k), (int, float))
                   and math.isfinite(keys[k]))]
    if bad:
        raise RuntimeError(f"the bench's serving leg gave no finite {bad}")
    return keys


def serve_phase(device, kernels, card):
    """Phase 15: (a) the serving engine on one card at the decode model's
    width, every response held to the oracle, no flash launch, one
    open-loop window; (b) the planted fault caught; (c) two ranks of a
    ``--serve`` job agreeing; (d) the bench's serving leg."""
    t0 = time.perf_counter()
    out = {"one_card": serve_one_card(device, card)}
    for kern in kernels:
        kern["launches_serve"] = out["one_card"]["launches"].get(
            kern["name"], 0)
    torch.cuda.empty_cache()
    out["proc"] = serve_proc_phase(device, card)
    out["bench"] = serve_bench(card)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 15: {out['seconds']:.1f} s")
    return out


def sw_resume(device, kernels, card):
    """Phase 16 (a): the flagship at its bench size resumes from a
    checkpoint bit for bit.  Run A goes to ``t_full`` uninterrupted; run
    B stops at ``t_half`` with a checkpoint every chunk, and a fresh
    solver in the same directory resumes it to ``t_full`` with every
    launch count set to 0 just before and read just after (the slice's
    main path).  Then the save of one chunk's state is timed."""
    from mpi4jax_tpu_torch.utils import checkpoint

    cfg = sw.SWConfig().bench_size()
    comm = MeshComm()
    n = ELASTIC_SW_CHUNK
    t_half = cfg.dt * (1 + n) + cfg.dt * n * 2  # warm-up + 2 timed chunks
    t_full = t_half + cfg.dt * n * 2
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        run_a, _, _ = sw.make_solver(cfg, comm, n, device=device)(t_full)
        run_a = clone(run_a)
        _, _, steps_b1 = sw.make_solver(cfg, comm, n, checkpoint_dir=work,
                                        device=device)(t_half)
        saved = checkpoint.latest_step(work)
        solve = sw.make_solver(cfg, comm, n, checkpoint_dir=work,
                               device=device)
        multi = solve.multistep
        reset_launch_counts()
        t0 = time.perf_counter()
        run_b, wall, steps = solve(t_full)
        resume_s = time.perf_counter() - t0
        counts = launch_counts()
        launches = {k: counts[k] + multi.replays * multi.captured.get(k, 0)
                    for k in counts}
        log(f"  (a) run B: {steps_b1} timed steps to t_half, latest "
            f"checkpoint chunk {saved}; its resume: {steps} steps in "
            f"{resume_s:.3f} s (saves included), launches {launches}")
        for kern in kernels:
            kern["launches_elastic"] = launches[kern["name"]]
        for name in ("sw_main", "sw_visc"):
            if launches[name] != steps or steps == 0:
                raise RuntimeError(f"(a) the resumed run launched {name} "
                                   f"{launches[name]} times in {steps} steps")
        for name, a, b in zip(sw.SWState._fields, run_a, run_b):
            same = torch.equal(a, b)
            log(f"  (a) {name}: resumed run equal to run A bit for bit "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError(f"(a) the resumed run differs from the "
                                   f"uninterrupted one in {name}")
        mgr = checkpoint.Manager(work / "timed", max_to_keep=1)
        save_ms = []
        for i in range(SAVE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(i, {"state": run_b, "t": np.float64(t_full)})
            save_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = (work / "timed" / str(SAVE_REPEATS - 1) /
                  checkpoint.PAYLOAD).stat().st_size
        state_bytes = sum(t.numel() * t.element_size() for t in run_b)
        log(f"  (a) one chunk's save: {statistics.median(save_ms):.2f} ms "
            f"(median of {SAVE_REPEATS}: "
            f"{', '.join(f'{x:.2f}' for x in save_ms)}"
            f"), {nbytes} bytes a checkpoint ({state_bytes} of state), on "
            f"{card}")
        return {"launches": launches, "steps": steps, "resume_s": resume_s,
                "save_ms": save_ms, "checkpoint_bytes": nbytes,
                "state_bytes": state_bytes}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def proc_recover(comm, device, out_dir, total, kill_rank, kill_step):
    """The failure-recovery contract (``tests/proc/test_failure_recovery
    .py``'s job) on this rank's device: ``total`` steps of a replicated
    state through an allreduce, rank 0 saving every 5 steps and waiting
    for the commit, every rank passing a barrier after each step; rank
    ``kill_rank`` exits hard after step ``kill_step`` unless
    ``OUT_DIR/killed`` exists (it makes it first).  A run resumes from
    ``OUT_DIR/ck``; rank 0 writes the final state to
    ``OUT_DIR/final.json``."""
    from mpi4jax_tpu_torch.utils import checkpoint

    out = pathlib.Path(out_dir)
    marker = out / "killed"
    rank = comm.rank()
    state = torch.arange(8.0, device=device)

    def step_fn(s, i):
        y, _ = p_ops.allreduce(s * (1.0 + 0.01 * i), op=p_ops.SUM, comm=comm)
        return y / comm.size + 0.001 * i

    with checkpoint.Manager(out / "ck", max_to_keep=2) as mgr:
        start = mgr.latest_step() or 0
        if start:
            state = mgr.restore(start, like={"state": state})["state"]
        print(f"[job] rank {rank} start={start}", flush=True)
        for i in range(start, total):
            state = step_fn(state, float(i))
            if rank == 0 and mgr.maybe_save(i + 1, {"state": state},
                                            every=5):
                mgr.wait_until_finished()
            p_ops.barrier(comm=comm)
            if rank == kill_rank and i + 1 == kill_step \
                    and not marker.exists():
                marker.touch()
                os._exit(17)  # a hard death, no cleanup
    if rank == 0:
        (out / "final.json").write_text(
            json.dumps([float(v) for v in state.cpu()]))


def proc_elastic(device, out_dir, steps, d, layers, batch, save_every,
                 kill_rank, kill_step):
    """A rank of ``run_elastic``'s job under ``--elastic``: the loop on
    this rank's device at the given sizes; once every rank has committed
    step ``kill_step`` (a barrier after the save), rank ``kill_rank``
    exits hard, in its first incarnation only (``T4J_REJOIN`` unset), and
    under ``--elastic rejoin`` the survivors hold their next step until
    its replacement has joined (under ``shrink`` they go on without it).
    Each rank writes its final parameters to ``OUT_DIR/rank<r>.npz`` and
    its result, with the wall time and world of every step, to
    ``OUT_DIR/rank<r>.json``; the dying rank writes its time of death to
    ``OUT_DIR/death``."""
    from mpi4jax_tpu_torch.models import train as ttrain
    from mpi4jax_tpu_torch.native import runtime
    from mpi4jax_tpu_torch.parallel.proc import world_comm_if_initialized
    from mpi4jax_tpu_torch.utils import checkpoint

    out = pathlib.Path(out_dir)
    rank = runtime.world_rank()
    n = runtime.world_size()
    timeline = []
    first_life = os.environ.get("T4J_REJOIN") != "1"
    hold = first_life and os.environ.get("T4J_ELASTIC") == "rejoin"
    fired = []
    build = ttrain.make_dp_train_step
    save = checkpoint.Manager.save

    def timed_build(c, **kw):
        step = build(c, **kw)

        def timed(params, batch_):
            if hold and c.size < n:
                # a survivor holds its next step until the replacement
                # has joined, so the job cannot end before the rejoin; it
                # then steps into a resize that may still be in flight,
                # as any caller of run_elastic does (the op tier's
                # check_health waits it out)
                deadline = time.monotonic() + ELASTIC_TIMEOUT_S / 2
                while True:
                    info = runtime.world_info()
                    if info["alive_count"] == n:
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError("the replacement never joined")
                    time.sleep(0.05)
            new = step(params, batch_)
            timeline.append((time.time(), c.size,
                             runtime.world_info()["epoch"]))
            return new

        return timed

    def planted_save(mgr, step, tree):
        save(mgr, step, tree)
        if step == kill_step and first_life and not fired:
            fired.append(step)
            p_ops.barrier(comm=world_comm_if_initialized())
            if rank == kill_rank:
                (out / "death").write_text(repr(time.time()))
                os._exit(42)

    ttrain.make_dp_train_step = timed_build
    checkpoint.Manager.save = planted_save
    result = ttrain.run_elastic(steps, out / "ck", d=d, layers=layers,
                                batch=batch, save_every=save_every,
                                device=device, log=lambda *a, **k: None)
    # the last step is always saved: its checkpoint is the final state
    mgr = checkpoint.Manager(out / "ck" / f"rank{rank}")
    like = ttrain.StackParams(
        layers=tuple((torch.empty(d, d, device=device),
                      torch.empty(d, device=device)) for _ in range(layers)),
        w_out=torch.empty(d, d, device=device))
    final = mgr.restore(mgr.latest_step(), like=like)
    leaves = [t for pair in final.layers for t in pair] + [final.w_out]
    np.savez(out / f"rank{rank}.npz",
             **{f"leaf{i}": t.cpu().numpy() for i, t in enumerate(leaves)})
    result["timeline"] = timeline
    (out / f"rank{rank}.json").write_text(json.dumps(result))


def recover_job(work, kill, flags=()):
    """``proc_recover``'s job of ``RECOVER["ranks"]`` ranks on the card
    in ``work``, ``kill`` its ``(KILL_RANK, KILL_STEP)``; (exit code,
    stdout, stderr, seconds)."""
    return launch.run_job(
        RECOVER["ranks"], [pathlib.Path(__file__).resolve(), "--proc-rank",
                           "recover", work, RECOVER["total"], *kill],
        platform="cuda", timeout=PROC_JOB_TIMEOUT_S, flags=flags)


def restarts_phase(card):
    """Phase 16 (b): the failure-recovery job under ``--restarts 1``:
    rank 1 dies after the step-5 save in the first attempt, the launcher
    relaunches the job, which resumes from step 5; its final state equals
    an uninterrupted run's bit for bit."""
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_recover_"))
    try:
        (work / "b").mkdir()
        (work / "c").mkdir()
        rc, out, err, secs = recover_job(
            work / "b", (RECOVER["kill_rank"], RECOVER["kill_step"]),
            ("--restarts", 1))
        ok = (rc == 0 and "attempt 1/2 exited with code 17" in err
              and "job succeeded on attempt 2/2" in err
              and "start=5" in out)
        log(f"  (b) --restarts 1 job: exit {rc} in {secs:.1f} s, relaunched "
            f"and resumed from step 5 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"(b) the --restarts job did not recover:\n"
                               f"{out[-2000:]}\n{err[-4000:]}")
        rc, out, err, oracle_s = recover_job(work / "c", (-1, -1))
        if rc != 0 or "start=0" not in out:
            raise RuntimeError(f"(b) the uninterrupted job failed:\n"
                               f"{out[-2000:]}\n{err[-4000:]}")
        resumed = json.loads((work / "b" / "final.json").read_text())
        oracle = json.loads((work / "c" / "final.json").read_text())
        same = resumed == oracle
        log(f"  (b) final state equal to an uninterrupted run's bit for bit "
            f"{'ok' if same else 'FAIL'} ({oracle_s:.1f} s) on {card}")
        if not same:
            raise RuntimeError(f"(b) resumed {resumed} != {oracle}")
        return {"job_s": secs, "oracle_s": oracle_s, "final": resumed}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def elastic_args(work, run):
    """The program arguments of ``proc_elastic``'s job in ``work``."""
    return [pathlib.Path(__file__).resolve(), "--proc-rank", "elastic", work,
            *(run[k] for k in ("steps", "d", "layers", "batch", "save_every",
                               "kill_rank", "kill_step"))]


def hold_elastic(work, run, rc, out, err, oracle):
    """The elastic job's checks: exit 0, every slot clean and in the
    final world, the survivors through at least 2 resizes, every rank's
    final world the full one and its parameters equal bit for bit to the
    no-fault job's in ``oracle`` (the same sizes, seed and steps with
    ``kill_rank`` -1: the rejoined world is the boot world again and
    every rank resumes after the committed step ``kill_step``, so a
    resume from the wrong step, a replayed step or the template restored
    in place of the checkpoint shows); returns ``(results,
    death-to-rejoined-step seconds)``."""
    n = run["ranks"]
    blob = out + err
    every = ", ".join(str(r) for r in range(n))
    checks = {
        "exit 0": rc == 0,
        "history printed": "world membership history: boot" in blob
        and f"rejoin({n})" in blob,
        "every slot clean": f"final world membership: {n}/{n} rank(s) "
        f"[{every}]" in blob,
        "no escalation": "escalating to abort" not in blob,
    }
    if not all(checks.values()):
        raise RuntimeError(f"the elastic job failed {checks}:\n"
                           f"{out[-2000:]}\n{err[-6000:]}")
    res = {r: json.loads((work / f"rank{r}.json").read_text())
           for r in range(n)}
    leaves = {r: load_results(work / f"rank{r}.npz") for r in range(n)}
    want = {r: load_results(oracle / f"rank{r}.npz") for r in range(n)}
    for r in range(n):
        clean = json.loads((oracle / f"rank{r}.json").read_text())
        if clean["resizes"] or clean["final_world"] != n:
            raise RuntimeError(f"the no-fault job's rank {r} resized: "
                               f"{clean}")
        if res[r]["final_world"] != n:
            raise RuntimeError(f"rank {r} ended in a world of "
                               f"{res[r]['final_world']}")
        if r != run["kill_rank"] and res[r]["resizes"] < 2:
            raise RuntimeError(f"survivor {r} saw {res[r]['resizes']} "
                               "resizes (want >= 2: the shrink and the "
                               "rejoin)")
        bad = [k for k in want[0] if not same_bits(leaves[r][k],
                                                   want[0][k])
               or not same_bits(want[r][k], want[0][k])]
        if bad:
            raise RuntimeError(f"rank {r}'s final parameters differ from "
                               f"the no-fault job's in {bad}")
    death = float((work / "death").read_text())
    rejoined = min(t for t, size, epoch in res[0]["timeline"]
                   if t > death and size == n)
    return res, rejoined - death


def elastic_rejoin_phase(card):
    """Phase 16 (c): ``run_elastic`` on 4 ranks on the card under
    ``--elastic rejoin``, rank 2 dying after the step-4 checkpoint, held
    to the same job without the death."""
    run = ELASTIC_RUN
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    try:
        (work / "oracle").mkdir()
        jobs = {}
        for name, where, kill in (("rejoin", work, run),
                                  ("oracle", work / "oracle",
                                   dict(run, kill_rank=-1, kill_step=-1))):
            jobs[name] = launch.run_job(
                run["ranks"], elastic_args(where, kill), platform="cuda",
                timeout=ELASTIC_TIMEOUT_S, flags=("--elastic", "rejoin"),
                env=ELASTIC_ENV)
        rc, out, err, oracle_s = jobs["oracle"]
        if rc != 0:
            raise RuntimeError(f"(c) the no-fault job failed:\n"
                               f"{out[-2000:]}\n{err[-4000:]}")
        rc, out, err, secs = jobs["rejoin"]
        res, rejoin_s = hold_elastic(work, run, rc, out, err, work / "oracle")
        log(f"  (c) {run['ranks']}-rank run_elastic (d {run['d']}, "
            f"{run['layers']} layers, batch {run['batch']}, {run['steps']} "
            f"steps) under --elastic rejoin: exit 0 in {secs:.1f} s, "
            f"resizes {[res[r]['resizes'] for r in sorted(res)]}, final "
            f"world {run['ranks']} on every rank, parameters equal to the "
            f"no-fault job's ({oracle_s:.1f} s) bit for bit; death to the "
            f"rejoined world's first step {rejoin_s:.3f} s, on {card}")
        return {"job_s": secs, "oracle_s": oracle_s, "rejoin_s": rejoin_s,
                "resizes": [res[r]["resizes"] for r in sorted(res)],
                "losses": res[0]["losses"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def elastic_phase(device, kernels, card):
    """Phase 16: (a) the flagship's resume at full width, (b) a
    ``--restarts`` job, (c) a ``--elastic rejoin`` job of
    ``run_elastic``."""
    t0 = time.perf_counter()
    out = {"sw_resume": sw_resume(device, kernels, card)}
    torch.cuda.empty_cache()
    out["restarts"] = restarts_phase(card)
    out["rejoin"] = elastic_rejoin_phase(card)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 16: {out['seconds']:.1f} s")
    return out


def ptxas_report(log_path):
    """ptxas's report from a build log: one ``(kernel, template
    arguments, registers, spill stores, spill loads)`` per compiled
    kernel (bytes of spill)."""
    rows, kernel = [], None
    for line in log_path.read_text().splitlines():
        entry = re.search(r"\d+([a-z_]+_kernel)(I\w*?E)?E", line)
        if "Compiling entry function" in line and entry:
            args = re.findall(r"(f|13__nv_bfloat16|Li(\d+)E)",
                              entry.group(2) or "")
            kernel = (entry.group(1), ", ".join(
                "float" if a == "f" else "bf16" if a.startswith("13")
                else d for a, d in args))
            spills = (0, 0)
        elif kernel and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill", line)
            spills = (int(nums[0]), int(nums[1]))
        elif kernel and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append((*kernel, regs, *spills))
            kernel = None
    return rows


def build_phase(sources=SOURCES, bridge=False):
    """Build every kernel source at once (one nvcc each, in threads:
    the compiles run as subprocesses), and with ``bridge`` the proc
    tier's native bridge beside them (one g++), and print nvcc's and
    g++'s seconds and ptxas's registers and spills per kernel and head
    dim."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + bridge) as pool:
        futures = [pool.submit(_build.load_library, name) for name in sources]
        if bridge:
            futures.append(pool.submit(native_build.ensure_built))
        for f in futures:
            f.result()
    log(f"  {', '.join(sources)}{' and the bridge' if bridge else ''} "
        f"built and loaded in {time.perf_counter() - t0:.2f} s")
    if bridge:
        log(f"  native bridge (dcn.cc, shm.cc, t4j_capi.cc): g++ "
            f"{native_build.build_seconds():.2f} s")
    report = {}
    for name in sources:
        log(f"  {name}.cu: nvcc {_build.build_seconds(name):.2f} s")
        for kernel, args, regs, stores, loads in ptxas_report(
                _build.library_dir(name) / "build.log"):
            log(f"    ptxas: {kernel}<{args}>: {regs} registers, spill "
                f"stores {stores} bytes, spill loads {loads} bytes")
            report[f"{kernel}<{args}>"] = {
                "registers": regs, "spill_stores": stores,
                "spill_loads": loads}
    return report


def flash_inputs(shape, dtype, device, seed):
    """q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D], normal, from a seed."""
    b, tq, tk, hq, hk, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.randn(s, generator=gen, device=device).to(dtype)
        for s in ((b, tq, hq, d), (b, tk, hk, d), (b, tk, hk, d))
    )


def causal_pairs(tq, tk, q_offset, k_offset):
    """(query, key) pairs a causal mask leaves visible."""
    q = q_offset + torch.arange(tq, dtype=torch.float64)
    return float((q - k_offset + 1).clamp(0, tk).sum())


def flash_check_cases():
    """The forward kernels' check cases: the f32 kernel's and the bf16
    kernel's on the same shapes, both transformer paths' shapes in bf16,
    the training path's shape in f32 (its default dtype), and the MoE
    path's in both."""
    b, t, h, d = (LONG["batch"], LONG["prompt"], DECODE_CFG.heads,
                  DECODE_CFG.head_dim)
    tb, tt = TRAIN["batch"], TRAIN["seq"]
    th, td = TRAIN_CFG.heads, TRAIN_CFG.head_dim
    cases = [
        # name, (B, Tq, Tk, Hq, Hkv, D), dtype, causal, q_offset, k_offset
        ("path", (b, t, t, h, h, d), torch.bfloat16, True, 0, 0),
        ("train_path", (tb, tt, tt, th, th, td), torch.bfloat16, True, 0,
         0),
        ("training", (2, 2048, 2048, 16, 16, 128), torch.bfloat16, True, 0,
         0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        cases += [
            ("padding" + sfx, (2, 1000, 1000, 4, 4, 64), dtype, False, 0, 0),
            ("offsets" + sfx, (1, 96, 160, 2, 2, 32), dtype, True, 64, 0),
            ("fully_masked" + sfx, (1, 96, 160, 2, 2, 32), dtype, True, 64,
             512),
            ("gqa" + sfx, (2, 300, 300, 8, 2, 64), dtype, True, 0, 0),
            ("d128_offsets" + sfx, (1, 500, 700, 2, 2, 128), dtype, True,
             100, 40),
        ]
    # last, so that every earlier case keeps its seed (its index)
    cases.append(("train_path_f32", (tb, tt, tt, th, th, td),
                  torch.float32, True, 0, 0))
    cases.append(("large_train", LARGE_SHAPE, torch.bfloat16, True, 0, 0))
    cases.append(("ulysses_long", ULYSSES_LONG_SHAPE, torch.bfloat16, True,
                  0, 0))
    cases.append(("prefill_tp2", PREFILL_TP2_SHAPE, torch.bfloat16, True, 0,
                  0))
    cases.append(("moe_path", MOE_SHAPE, torch.bfloat16, True, 0, 0))
    cases.append(("moe_path_f32", MOE_SHAPE, torch.float32, True, 0, 0))
    return cases


def operations_ms(flops, dtype):
    """(ms, route) of ``flops`` useful operations at the least time the
    card needs for them in ``dtype``: bf16 on the bf16 tensor cores; f32
    the lesser of the CUDA cores and 3xTF32 on the TF32 tensor cores."""
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16_PER_S * 1e3, "bf16 tensor cores"
    return min((flops / PEAK_F32_PER_S * 1e3, "f32 CUDA cores"),
               (3 * flops / PEAK_TF32_PER_S * 1e3, "3xTF32 tensor cores"))


def flash_bounds(shape, dtype, with_lse):
    """(flops, bytes, bound_ms, bound_by, route) of one causal forward
    at ``shape``: 2 products of 2·D operations per visible pair at
    :func:`operations_ms`; q, k, v read once, out written once, and m
    and l (f32, one each a row) when asked."""
    b, tq, tk, hq, hk, d = shape
    esz = torch.tensor([], dtype=dtype).element_size()
    flops = 4 * d * b * hq * causal_pairs(tq, tk, 0, 0)
    nbytes = (2 * b * tq * hq * d + 2 * b * tk * hk * d) * esz
    if with_lse:
        nbytes += 2 * 4 * b * hq * tq
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms, route = operations_ms(flops, dtype)
    if bytes_ms >= flops_ms:
        return flops, nbytes, bytes_ms, "bytes", "device memory"
    return flops, nbytes, flops_ms, "operations", route


def mesh_shape_timings(device, part):
    """The bf16 kernels at the shapes the transformer's meshes give them
    (``part`` "fwd": the forward at Ulysses's long leg, with m and l, and
    at the decode prefill at tp 2, without; "bwd": the backward pair at
    Ulysses's), each beside one causal scaled_dot_product_attention call
    (forward, or its backward: dq, dk and dv together), its plain
    version and its bound; CUDA events, as the timed phases take them.
    Returns the readings."""
    out = {}
    bf16 = torch.bfloat16
    if part == "fwd":
        for label, shape, with_lse in (
                ("ulysses_long", ULYSSES_LONG_SHAPE, True),
                ("prefill_tp2", PREFILL_TP2_SHAPE, False)):
            q, k, v = flash_inputs(shape, bf16, device, seed=0)
            kw = dict(causal=True, scale=1.0 / math.sqrt(shape[5]),
                      with_lse=with_lse)
            ms = time_ms(lambda: kflash.flash_fwd(q, k, v, **kw), n=3,
                         repeats=3)
            plain_ms = time_ms(lambda: kflash.flash_attention_reference(
                q, k, v, block_k=kflash.kernel_block_k(bf16), **kw),
                n=1, repeats=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), n=10, repeats=3)
            flops, nbytes, bound_ms, bound_by, _ = flash_bounds(
                shape, bf16, with_lse)
            out[f"flash_fwd_mma_{label}"] = {
                "shape": list(shape), "with_lse": with_lse, "ms": ms,
                "tflops": flops / (ms * 1e-3) / 1e12, "library_ms": lib_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
            del q, k, v, qt, kt, vt
    else:
        shape = ULYSSES_LONG_SHAPE
        args, kw = bwd_inputs(shape, bf16, True, 0, 0, device, seed=0)
        q, k, v, g = (x.transpose(1, 2).contiguous() for x in args[:4])
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, (q, k, v), g, retain_graph=True), n=5, repeats=3)
        del q, k, v, g, o
        bounds = bwd_bounds(shape, bf16, True)
        plain = dict(block_k=kbwd.kernel_block_k(bf16), **kw)
        for name, fn, plain_fn in (
                ("dkv", kbwd.flash_bwd_dkv, kbwd.flash_bwd_dkv_reference),
                ("dq", kbwd.flash_bwd_dq, kbwd.flash_bwd_dq_reference)):
            ms = time_ms(lambda: fn(*args, **kw), n=3, repeats=3, warmup=1)
            plain_ms = time_ms(lambda: plain_fn(*args, **plain), n=1,
                               repeats=3, warmup=1)
            flops, _, bound_ms, bound_by, _ = bounds[name]
            out[f"{bwd_kernel_name(name, bf16)}_ulysses_long"] = {
                "shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                "tflops": flops / (ms * 1e-3) / 1e12,
                "library_ms": lib_ms, "library": "backward of "
                "scaled_dot_product_attention (dq, dk and dv together)",
                "bound_ms": bound_ms, "bound_by": bound_by}
        del args
    for name, r in out.items():
        log(f"  {name} at {r['shape']} bf16 causal: {r['ms']:.4f} ms per "
            f"launch ({r['tflops']:.2f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f} ms, scaled_dot_product_"
            f"attention{' backward' if part == 'bwd' else ''} "
            f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}")
    return out


def flash_kernel_phase(device, timed=True, mesh_timings=True):
    """Both forward kernels against their plain version at each kernel's
    key tile; then (``mesh_timings``) :func:`mesh_shape_timings`' forward
    readings; then (``timed``) the bf16 kernel timed at both transformer
    paths' shapes and the MFU preset's, and the f32 kernel at the f32 decode check's prefill
    shape and at the training path's shape, each beside its bound, its
    plain version and one scaled_dot_product_attention call."""
    errs_by = {}
    failed = []
    for i, (name, shape, dtype, causal, qo, ko) in enumerate(
            flash_check_cases()):
        q, k, v = flash_inputs(shape, dtype, device, seed=i)
        kw = dict(causal=causal, scale=1.0 / math.sqrt(shape[5]),
                  q_offset=qo, k_offset=ko, with_lse=True)
        out, m, l = kflash.flash_fwd(q, k, v, **kw)
        r_out, r_m, r_l = kflash.flash_attention_reference(
            q, k, v, block_k=kflash.kernel_block_k(dtype), **kw)
        torch.cuda.synchronize()
        diff = (out.float() - r_out.float()).abs()
        errs = {
            "out_max": diff.max().item(),
            "out_mean": diff.mean().item(),
            "m": ((m - r_m).abs() / r_m.abs().clamp(min=1)).max().item(),
            "l": ((l - r_l).abs() / r_l.abs().clamp(min=1)).max().item(),
        }
        lim = FLASH_LIMITS[dtype]
        finite = bool(torch.isfinite(out.float()).all())
        ok = (errs["out_max"] <= lim["out_max"]
              and errs["out_mean"] <= lim["out_mean"]
              and max(errs["m"], errs["l"]) <= lim["stat"] and finite)
        kname = ("flash_fwd_mma" if dtype == torch.bfloat16
                 else "flash_fwd")
        log(f"  {kname} {name} {list(shape)} {str(dtype)[6:]} causal="
            f"{causal} q_offset={qo} k_offset={ko}: out max_abs_err "
            f"{errs['out_max']:.3e} (limit {lim['out_max']:g}), mean_abs_err "
            f"{errs['out_mean']:.3e} (limit {lim['out_mean']:g}), m "
            f"{errs['m']:.3e}, l {errs['l']:.3e} (limit {lim['stat']:g}), "
            f"finite {finite} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        errs_by[name] = errs
        del q, k, v, out, m, l, r_out, r_m, r_l, diff
    if failed:
        raise RuntimeError(f"the flash forward kernels disagree with their "
                           f"plain version on cases {failed}")
    if mesh_timings:
        mesh_shape_timings(device, "fwd")
    if not timed:
        return None

    def worst(names):
        return {key: max(errs_by[n][key] for n in names)
                for key in ("out_max", "out_mean", "m", "l")}

    f32_names = [c[0] for c in flash_check_cases()
                 if c[2] == torch.float32]
    kernels = {}
    b, t, h, d = (LONG["batch"], LONG["prompt"], DECODE_CFG.heads,
                  DECODE_CFG.head_dim)
    tshape = (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], TRAIN_CFG.heads,
              TRAIN_CFG.kv_heads, TRAIN_CFG.head_dim)
    f32_shape = (F32_DECODE["batch"], F32_DECODE["prompt"],
                 F32_DECODE["prompt"], h, h, d)
    timings = [
        # kernel, key prefix, shape, dtype, with m and l (as its path
        # calls it), launches, repeats, errors
        ("flash_fwd_mma", "", (b, t, t, h, h, d), torch.bfloat16, False,
         5, errs_by["path"]),
        ("flash_fwd_mma", "_train_shape", tshape, torch.bfloat16, True, 3,
         errs_by["train_path"]),
        ("flash_fwd_mma", "_large_shape", LARGE_SHAPE, torch.bfloat16, True,
         3, errs_by["large_train"]),
        ("flash_fwd", "", f32_shape, torch.float32, False, 5,
         worst(f32_names)),
        ("flash_fwd", "_train_shape", tshape, torch.float32, True, 3,
         errs_by["train_path_f32"]),
    ]
    for kname, key, shape, dtype, with_lse, n, errs in timings:
        q, k, v = flash_inputs(shape, dtype, device, seed=0)
        kw = dict(causal=True, scale=1.0 / math.sqrt(shape[5]),
                  with_lse=with_lse)
        ms = time_ms(lambda: kflash.flash_fwd(q, k, v, **kw), n=n,
                     repeats=3)
        plain_ms = time_ms(
            lambda: kflash.flash_attention_reference(
                q, k, v, block_k=kflash.kernel_block_k(dtype), **kw),
            n=1, repeats=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            n=10, repeats=3)
        library_names = library_kernels(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True))
        del q, k, v, qt, kt, vt
        flops, nbytes, bound_ms, bound_by, route = flash_bounds(
            shape, dtype, with_lse)
        tflops = flops / (ms * 1e-3) / 1e12
        log(f"  {kname} at {list(shape)} {str(dtype)[6:]} causal"
            f"{' with m, l' if with_lse else ''}: {ms:.4f} ms per launch "
            f"(plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms); {flops:.4e} flops, {nbytes / 1e6:.1f} "
            f"MB; bound {bound_ms:.4f} ms by {bound_by} ({route}) at the "
            f"data-sheet peak ({tflops:.2f} TFLOP/s achieved); the "
            f"library call ran {library_names or 'not measured'}")
        entry = kernels.setdefault(kname, {
            "name": kname,
            "route": "cuda",
            "source": f"mpi4jax_tpu_torch/kernels/csrc/{kname}.cu",
            "replaces": "mpi4jax_tpu/ops/flash.py:97",
            "launches": None,  # filled from the path phases
            "max_abs_err": errs["out_max"],
            "mean_abs_err": errs["out_mean"],
            "max_stat_err": max(errs["m"], errs["l"]),
        })
        entry.update({
            f"ms{key}": ms,
            f"plain_ms{key}": plain_ms,
            f"bound_ms{key}": bound_ms,
            f"bound_by{key}": bound_by,
            f"bound_route{key}": route,
            f"library_ms{key}": library_ms,
            f"library_kernels{key}": library_names,
            f"bytes{key}": nbytes,
            f"flops{key}": flops,
            f"tflops{key}": tflops,
            f"shape{key}": list(shape),
        })
    return kernels["flash_fwd"], kernels["flash_fwd_mma"]


def plain_flash(q, k, v, *, causal):
    """The prefill's attention through the flash kernel's plain version
    at the kernel's key tile, on the same (CUDA) tensors."""
    return kflash.flash_attention_reference(
        q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
        block_k=kflash.kernel_block_k(q.dtype),
    )


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def first_difference(got, want):
    """(row, position) of the first token where ``got`` and ``want``
    differ, by position, or None."""
    rows, cols = torch.nonzero(got != want, as_tuple=True)
    if not len(cols):
        return None
    i = int(torch.argmin(cols * got.shape[0] + rows))
    return int(rows[i]), int(cols[i])


def step_logits(params, prompts, cfg, max_len, target, key=None, **kw):
    """The eager decoder's logits from which it chooses the token at
    position ``target`` (at least the prompt length), for every row."""
    tp = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1)).sub("tp")
    loop = tfm._DecodeLoop(params, prompts, cfg, max_len, comm_tp=tp,
                           batched=True, **kw)
    if target == loop.p_len:  # the prefill's choice
        return tfm._prefill_sharded(
            params, prompts, cfg, tp, loop.hq_l, loop.hk_l, max_len,
            impl=kw["prefill_impl"])[1]
    loop.prepare(params, prompts, key)
    for view_len, first, stop in loop.segments:
        loop.pos.fill_(first)
        for pos in range(first, stop):
            if pos + 1 == target:
                return tfm._decode_step_sharded(
                    params, loop.cache[:, :, :, :view_len],
                    loop.out[:, pos], loop.pos, cfg, tp, loop.hq_l,
                    loop.hk_l)[1]
            loop.step(params, view_len)
    raise ValueError(f"no step chooses position {target}")


def hold_graph_to_eager(label, got, params, prompts, cfg, max_len, **kw):
    """The graph decode's tokens ``got`` against the eager decoder
    (``tfm._greedy_decode``) on the same inputs, by ``torch.equal``; on a
    difference, the first differing position and the eager logits there
    are printed before it raises."""
    tp = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1)).sub("tp")
    want = tfm._greedy_decode(params, prompts, cfg, max_len, comm_tp=tp,
                              batched=True, **kw)
    same = torch.equal(got, want)
    log(f"  {label}: graph replays and the eager decoder give "
        f"{'identical' if same else 'DIFFERENT'} tokens")
    if same:
        return
    row, col = first_difference(got, want)
    loop_kw = {"sampler": "greedy", "temperature": 1.0, "top_k": None,
               **kw}
    logits = step_logits(params, prompts, cfg, max_len, col,
                         **loop_kw)[row].float()
    top = torch.topk(logits, 4)
    log(f"  first difference: row {row}, position {col}: graph token "
        f"{int(got[row, col])}, eager {int(want[row, col])}; eager logits "
        f"top 4 {top.values.tolist()} at {top.indices.tolist()}")
    raise RuntimeError(f"{label}: graph decode differs from eager")


def bmm_out_dtype_probe(device):
    """Whether this torch takes ``torch.bmm(a, b, out_dtype=
    torch.float32)`` on bf16 CUDA operands (f32 scores without widening
    the KV view first), and how far it is from the widened product."""
    a = torch.randn(4, 8, 64, device=device).to(torch.bfloat16)
    b = torch.randn(4, 64, 256, device=device).to(torch.bfloat16)
    try:
        got = torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        log(f"  torch.bmm(bf16, bf16, out_dtype=torch.float32): not "
            f"available ({type(exc).__name__}: {str(exc)[:120]})")
        return None
    err = (got - a.float() @ b.float()).abs().max().item()
    log(f"  torch.bmm(bf16, bf16, out_dtype=torch.float32): available, "
        f"{got.dtype}, max |difference| from the widened f32 product "
        f"{err:.3e}")
    return err


def counted_decode(decode, *args):
    """One call of ``decode`` with every launch count set to 0 just
    before: (tokens, seconds, kernel launches, graphs captured, steps
    replayed)."""
    captures, replays = decode.captures, decode.replays
    reset_launch_counts()
    out, wall = synced_seconds(lambda: decode(*args))
    return (out, wall, launch_counts(), decode.captures - captures,
            decode.replays - replays)


def check_decode_counts(label, counts, want):
    """``counts`` (launches, captures, replays) against ``want``."""
    launches, captures, replays = counts
    got = {"flash_fwd_mma": launches["flash_fwd_mma"],
           "flash_fwd": launches["flash_fwd"], "captures": captures,
           "replays": replays}
    log(f"  {label}: {got}")
    if got != want:
        raise RuntimeError(f"{label}: {got}, expected {want}")


def decode_path_phase(device, flash_kernel, f32_kernel, copy_rate):
    cfg = DECODE_CFG
    batch, p_len, max_len = LONG["batch"], LONG["prompt"], LONG["max_len"]
    bucket = LONG["kv_bucket"]
    comm = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    dp, tp = comm.sub("dp"), comm.sub("tp")
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(cfg, generator=gen, dtype=torch.bfloat16,
                             device=device)
    prompts = torch.randint(0, cfg.vocab, (batch, p_len), generator=gen,
                            device=device, dtype=torch.int32)
    decode = tfm.make_global_decode(
        dp, tp, cfg, max_len, kv_bucket=bucket,
        prefill_impl=LONG["prefill_impl"], device=device,
    )
    n_views = len(tfm._segments(p_len, max_len, bucket))
    n_steps = max_len - 1 - p_len
    eager_kw = dict(kv_bucket=bucket, prefill_impl="flash")
    flash = {"flash_fwd_mma": cfg.layers, "flash_fwd": 0}

    # the first call runs eagerly and captures a graph per view length;
    # every later one replays them
    first, warm_s, *counts = counted_decode(decode, params, prompts)
    check_decode_counts("first call (eager, then the captures)", counts,
                        {**flash, "captures": n_views, "replays": 0})
    out, wall, *counts = counted_decode(decode, params, prompts)
    check_decode_counts("second call (graph replays)", counts,
                        {**flash, "captures": 0, "replays": n_steps})
    launches = counts[0]
    flash_kernel["launches"] = launches["flash_fwd_mma"]
    log(f"  make_global_decode(prefill_impl='flash', kv_bucket={bucket}): "
        f"{n_views} graphs, {n_steps} replays a decode; one decode "
        f"{wall:.4f} s (first call {warm_s:.4f} s)")
    if tuple(out.shape) != (batch, max_len) or out.dtype != torch.int32:
        raise RuntimeError(f"decode returned {out.dtype} {tuple(out.shape)}")
    if not torch.equal(out[:, :p_len], prompts):
        raise RuntimeError("decode did not echo the prompt")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise RuntimeError("decode produced tokens outside the vocabulary")
    if not torch.equal(out, first):
        raise RuntimeError("the graph replays differ from the first call")
    hold_graph_to_eager(f"bf16 batch {batch}, prompt {p_len}", out, params,
                        prompts, cfg, max_len, **eager_kw)

    hq = cfg.heads
    (_, logits), prefill_s = synced_seconds(lambda: tfm._prefill_sharded(
        params, prompts, cfg, tp, hq, cfg.kv_heads, max_len, impl="flash"))
    n_gen = max_len - p_len
    gen_step_ms = (wall - prefill_s) / n_gen * 1e3
    walls = []
    for _ in range(2):  # run_decode's bursts of 2 decodes
        _, burst = synced_seconds(
            lambda: (decode(params, prompts), decode(params, prompts)))
        walls.append(burst / 2)
    best = min(walls)
    rate = batch * n_gen / best
    bytes_per_step, params_bytes = transformer_decode.decode_bytes_per_step(
        cfg, params, batch, p_len, max_len)
    bound_rate = batch * copy_rate / bytes_per_step
    sheet_rate = batch * PEAK_BYTES_PER_S / bytes_per_step
    log(f"  prefill {prefill_s * 1e3:.4f} ms ({cfg.layers} flash launches, "
        f"{flash_kernel['ms'] * cfg.layers:.4f} ms of kernel time at the "
        f"kernel phase's rate); generate {gen_step_ms:.4f} ms per "
        f"generated token after it ({n_gen} tokens, {n_steps} replayed "
        f"steps)")
    log(f"  {rate:.2f} generated tokens/s (best of 2 bursts of 2 decodes, "
        f"{best:.4f} s per decode); bytes per generated step "
        f"{bytes_per_step:.4e} (params {params_bytes:.4e}): bound "
        f"{bound_rate:.2f} tokens/s at the measured copy rate, "
        f"{sheet_rate:.2f} at the data-sheet rate")

    # the state across calls: other prompts replay the same graphs; other
    # parameter tensors are captured anew
    prompts2 = torch.randint(0, cfg.vocab, (batch, p_len), generator=gen,
                             device=device, dtype=torch.int32)
    out2, _, *counts = counted_decode(decode, params, prompts2)
    check_decode_counts("other prompts", counts,
                        {**flash, "captures": 0, "replays": n_steps})
    hold_graph_to_eager("bf16, other prompts", out2, params, prompts2, cfg,
                        max_len, **eager_kw)
    gen2 = torch.Generator(device=device).manual_seed(1)
    params2 = tfm.init_params(cfg, generator=gen2, dtype=torch.bfloat16,
                              device=device)
    decode(params2, prompts2)  # eager, then the captures
    out3, _, *counts = counted_decode(decode, params2, prompts2)
    check_decode_counts("other parameter tensors, second call", counts,
                        {**flash, "captures": 0, "replays": n_steps})
    if decode.captures != 2 * n_views:
        raise RuntimeError(f"{decode.captures} graphs captured, expected "
                           f"{2 * n_views}")
    hold_graph_to_eager("bf16, other parameter tensors", out3, params2,
                        prompts2, cfg, max_len, **eager_kw)
    del params2, out2, out3

    # kernel prefill against plain prefill, bf16, full width
    _, plain_logits = tfm._prefill_sharded(
        params, prompts, cfg, tp, hq, cfg.kv_heads, max_len,
        impl=plain_flash)
    scale = logits.float().abs().max().item()
    err = (logits.float() - plain_logits.float()).abs().max().item()
    ok = err <= DECODE_LOGIT_RTOL * scale
    log(f"  bf16 last-prompt logits, kernel vs plain prefill: max_abs_err "
        f"{err:.4e}, max|logit| {scale:.4f} (limit {DECODE_LOGIT_RTOL:g} of "
        f"it) {'ok' if ok else 'FAIL'}; argmax agrees on "
        f"{(logits.argmax(-1) == plain_logits.argmax(-1)).sum().item()}/"
        f"{batch} rows")
    if not ok:
        raise RuntimeError("kernel and plain prefill disagree at bf16")
    plain_out = tfm._greedy_decode(
        params, prompts, cfg, max_len, comm_tp=tp, batched=True,
        kv_bucket=bucket, prefill_impl=plain_flash)
    token_share = (plain_out[:, p_len:] == out[:, p_len:]).float().mean(
        ).item()
    log(f"  bf16 generated tokens identical, kernel vs plain prefill: "
        f"{token_share:.4f} of {batch * n_gen}")
    del plain_out

    # categorical sampling on the graphs, against its eager run
    cat_kw = dict(sampler="categorical", temperature=CATEGORICAL["temperature"],
                  top_k=CATEGORICAL["top_k"])
    key = torch.tensor([0, CATEGORICAL["seed"]])
    sample = tfm.make_global_decode(
        dp, tp, cfg, max_len, kv_bucket=bucket, prefill_impl="flash",
        device=device, **cat_kw)
    sample(params, prompts, key)  # eager, then the captures
    drawn, cat_wall, *counts = counted_decode(sample, params, prompts, key)
    check_decode_counts("categorical, second call", counts,
                        {**flash, "captures": 0, "replays": n_steps})
    hold_graph_to_eager(
        f"bf16 categorical (top_k {cat_kw['top_k']}, temperature "
        f"{cat_kw['temperature']})", drawn, params, prompts, cfg, max_len,
        key=prng.raw_key(key, device), **cat_kw, **eager_kw)
    share = (drawn[:, p_len:] == out[:, p_len:]).float().mean().item()
    log(f"  categorical: one decode {cat_wall:.4f} s; {share:.4f} of its "
        f"tokens equal the greedy decode's")
    card_keys = prng.fold_in(prng.fold_in(prng.raw_key(key, device), p_len),
                             torch.arange(batch, device=device))
    host_keys = prng.fold_in(prng.fold_in(prng.raw_key(key), p_len),
                             torch.arange(batch))
    bits_same = torch.equal(prng.random_bits(card_keys, (cfg.vocab,)).cpu(),
                            prng.random_bits(host_keys, (cfg.vocab,)))
    log(f"  threefry random_bits of the first draw's row keys, "
        f"[{batch}, {cfg.vocab}]: card and CPU "
        f"{'identical' if bits_same else 'DIFFERENT'}")
    if not bits_same:
        raise RuntimeError("the card's threefry bits differ from the CPU's")
    bf16_run = (decode, params, prompts)
    del out, sample, drawn

    # f32: the graphs, the eager decoder and the plain prefill's decode
    # give identical tokens
    fb, fp, fm = F32_DECODE["batch"], F32_DECODE["prompt"], \
        F32_DECODE["max_len"]
    params32 = tfm.init_params(cfg, generator=gen, device=device)
    prompts32 = torch.randint(0, cfg.vocab, (fb, fp), generator=gen,
                              device=device, dtype=torch.int32)
    decode32 = tfm.make_global_decode(
        dp, tp, cfg, fm, kv_bucket=bucket, prefill_impl="flash",
        device=device)
    n32 = len(tfm._segments(fp, fm, bucket))
    _, _, *counts = counted_decode(decode32, params32, prompts32)
    f32_flash = {"flash_fwd_mma": 0, "flash_fwd": cfg.layers}
    check_decode_counts("f32 first call (eager, then the captures)", counts,
                        {**f32_flash, "captures": n32, "replays": 0})
    f32_kernel["launches"] = counts[0]["flash_fwd"]
    kernel_out, _, *counts = counted_decode(decode32, params32, prompts32)
    check_decode_counts("f32 second call (graph replays)", counts,
                        {**f32_flash, "captures": 0,
                         "replays": fm - 1 - fp})
    hold_graph_to_eager(f"f32 batch {fb}, prompt {fp}, max_len {fm}",
                        kernel_out, params32, prompts32, cfg, fm,
                        **eager_kw)
    plain_out = tfm._greedy_decode(
        params32, prompts32, cfg, fm, comm_tp=tp, batched=True,
        kv_bucket=bucket, prefill_impl=plain_flash)
    same = torch.equal(kernel_out, plain_out)
    log(f"  f32: kernel and plain prefill give "
        f"{'identical' if same else 'DIFFERENT'} tokens")
    if not same:
        raise RuntimeError("kernel and plain paths differ in f32")
    bmm_err = bmm_out_dtype_probe(device)
    return {"prefill_ms": prefill_s * 1e3, "generate_ms_per_step":
            gen_step_ms, "tokens_per_s": rate, "decode_s": best,
            "bmm_out_dtype_err": bmm_err,
            "bytes_per_step": bytes_per_step, "bound_tokens_per_s":
            bound_rate, "bf16_token_share": token_share, "graphs": n_views,
            "replays_per_decode": n_steps, "categorical_decode_s": cat_wall,
            "categorical_greedy_share": share}, bf16_run


def decode_profile_phase(decode, params, prompts, path):
    """Device time by kernel over one decode call (its generate steps
    graph replays), split at the end of the prefill's last flash launch;
    the generation loop's device time and launches per replayed step, and
    its idle share against its untraced time from the path phase and
    against the span of its own timeline in the trace."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decode(params, prompts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("  the profiler recorded no device activity: not measured")
        return None
    flash_end = max(e.time_range.end for e in kernels
                    if "flash_fwd_mma_kernel" in e.name)
    phases = {"prefill": {}, "generate": {}}
    for e in kernels:
        part = phases["prefill" if e.time_range.start < flash_end
                      else "generate"]
        total, count = part.get(e.name, (0.0, 0))
        part[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    n_gen = LONG["max_len"] - LONG["prompt"]
    steps = path["replays_per_decode"]
    generate = [e for e in kernels if e.time_range.start >= flash_end]
    span_ms = (max(e.time_range.end for e in generate)
               - min(e.time_range.start for e in generate)) / 1e3
    res = {}
    for name, part in phases.items():
        busy = sum(ms for ms, _ in part.values())
        launches = sum(c for _, c in part.values())
        log(f"  {name}: device busy {busy:.4f} ms in {launches} launches")
        for kname, (ms, count) in sorted(part.items(),
                                         key=lambda kv: -kv[1][0])[:6]:
            log(f"    {ms:.4f} ms, {count} launches: {kname[:90]}")
        res[name] = {"device_ms": busy, "launches": launches}
    flash_ms = sum(ms for kname, (ms, _) in phases["prefill"].items()
                   if "flash_fwd_mma_kernel" in kname)
    gen_untraced_ms = path["generate_ms_per_step"] * n_gen
    idle = 1 - res["generate"]["device_ms"] / gen_untraced_ms
    gen_ms = res["generate"]["device_ms"]
    log(f"  flash kernel {flash_ms:.4f} ms of the prefill's "
        f"{res['prefill']['device_ms']:.4f} ms device time; generation: "
        f"{gen_ms / n_gen:.4f} ms device time per generated token of "
        f"{path['generate_ms_per_step']:.4f} ms untraced (idle share "
        f"{idle:.4f}); per replayed step {gen_ms / steps:.4f} ms in "
        f"{res['generate']['launches'] / steps:.2f} launches, the "
        f"generation's traced timeline {span_ms:.4f} ms (idle share "
        f"{1 - gen_ms / span_ms:.4f})")
    res["flash_ms"] = flash_ms
    res["generate_idle_share"] = idle
    res["generate_ms_per_replay"] = gen_ms / steps
    res["launches_per_replay"] = res["generate"]["launches"] / steps
    res["generate_traced_idle_share"] = 1 - gen_ms / span_ms
    return res


def short_decode_phase(device):
    """The bench's two batch-16 decode legs (``bench.DECODE_LEGS``,
    ``run_decode`` at the decode benchmark's short prompt, bf16) with one
    timed burst each: generated tokens/s and seconds per decode."""
    recs = {}
    for leg, key, kw in port_bench.DECODE_LEGS:
        if kw["batch"] != 16:
            continue
        rec = transformer_decode.run_decode(
            **port_bench.DECODE_MODEL, **kw, bf16=True, batches=1,
            device=device)
        steps = rec["max_len"] - 1 - rec["prompt"]
        log(f"  {key}: {rec['value']:.2f} generated tokens/s, "
            f"{rec['wall_s']:.4f} s a decode ({steps} generate steps, "
            f"{rec['wall_s'] / steps * 1e3:.4f} ms each with the prefill)")
        recs[key] = rec["value"]
    return recs



def bwd_bounds(shape, dtype, causal):
    """(flops, bytes, bound_ms, bound_by, route) of each backward kernel
    at ``shape`` (B, Tq, Tk, Hq, Hkv, D), keyed "dkv" and "dq": dkv needs
    4 products per visible pair (s, dP, dV, dK), dq 3 (s, dP, dQ), each
    2·D operations, at :func:`operations_ms` (the bf16 kernels' extra
    products for ds's mid and lo terms are not counted); every input read
    once (q, k, v, dO, and m, l, delta in f32), every output written
    once."""
    b, tq, tk, hq, hk, d = shape
    esz = torch.tensor([], dtype=dtype).element_size()
    pairs = causal_pairs(tq, tk, 0, 0) if causal else float(tq * tk)
    q_bytes = b * tq * hq * d * esz
    kv_bytes = b * tk * hk * d * esz
    stat_bytes = 3 * b * hq * tq * 4
    inputs = 2 * q_bytes + 2 * kv_bytes + stat_bytes
    res = {}
    for part, products, nbytes in (("dkv", 4, inputs + 2 * kv_bytes),
                                   ("dq", 3, inputs + q_bytes)):
        flops = 2 * products * d * b * hq * pairs
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        flops_ms, route = operations_ms(flops, dtype)
        res[part] = ((flops, nbytes, bytes_ms, "bytes", "device memory")
                     if bytes_ms >= flops_ms else
                     (flops, nbytes, flops_ms, "operations", route))
    return res


def bwd_check_cases():
    """The backward kernels' check cases: the training path's shape in
    each dtype, and padding, q/k offsets, fully masked rows,
    grouped-query heads and D 32 and 64, and the MoE path's shape in
    each dtype (f32: flash_bwd.cu, bf16: flash_bwd_mma.cu)."""
    b, t = TRAIN["batch"], TRAIN["seq"]
    h, d = TRAIN_CFG.heads, TRAIN_CFG.head_dim
    cases = [
        # name, (B, Tq, Tk, Hq, Hkv, D), dtype, causal, q_offset, k_offset
        ("path", (b, t, t, h, h, d), torch.bfloat16, True, 0, 0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        cases += [
            ("padding" + sfx, (2, 1000, 1000, 4, 4, 64), dtype, False, 0, 0),
            ("offsets" + sfx, (1, 96, 160, 2, 2, 32), dtype, True, 64, 0),
            ("fully_masked" + sfx, (1, 200, 300, 2, 2, 64), dtype, True, 0,
             40),
            ("d32" + sfx, (2, 256, 256, 4, 4, 32), dtype, True, 0, 0),
        ]
    cases += [
        ("gqa", (2, 300, 300, 8, 2, 64), torch.float32, True, 0, 0),
        ("gqa_bf16", (2, 1024, 1024, 8, 2, 128), torch.bfloat16, True, 0,
         0),
        ("d64_bf16", (2, 512, 512, 4, 4, 64), torch.bfloat16, True, 0, 0),
        # last, so that every earlier case keeps its seed (its index)
        ("path_f32", (b, t, t, h, h, d), torch.float32, True, 0, 0),
        ("large_train", LARGE_SHAPE, torch.bfloat16, True, 0, 0),
        ("ulysses_long", ULYSSES_LONG_SHAPE, torch.bfloat16, True, 0, 0),
        ("moe_path", MOE_SHAPE, torch.bfloat16, True, 0, 0),
        ("moe_path_f32", MOE_SHAPE, torch.float32, True, 0, 0),
    ]
    return cases


def bwd_inputs(shape, dtype, causal, qo, ko, device, seed):
    """q, k, v and a cotangent from a seed, the kernel forward's (out, m,
    l) on them, and delta."""
    q, k, v = flash_inputs(shape, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(1000 + seed)
    g = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(shape[5]), q_offset=qo,
              k_offset=ko)
    out, m, l = kflash.flash_fwd(q, k, v, with_lse=True, **kw)
    return (q, k, v, g, m, l, kbwd.row_delta(g, out)), kw


def bwd_pair(args, kw, dtype):
    """The backward kernels' dq, dk, dv (``got``) and their plain
    versions' at the kernel's key tile (``want``) on the inputs of
    :func:`bwd_inputs`."""
    got = dict(zip(("dk", "dv"), kbwd.flash_bwd_dkv(*args, **kw)))
    got["dq"] = kbwd.flash_bwd_dq(*args, **kw)
    plain = dict(block_k=kbwd.kernel_block_k(dtype), **kw)
    want = dict(zip(("dk", "dv"), kbwd.flash_bwd_dkv_reference(
        *args, **plain)))
    want["dq"] = kbwd.flash_bwd_dq_reference(*args, **plain)
    torch.cuda.synchronize()
    return got, want


def witness_grads(q, k, v, g, *, causal, scale, q_offset, k_offset):
    """dq, dk, dv of softmax attention computed densely in float64 from
    the same q, k, v and cotangent g, one (batch, query head) at a time:
    the exact gradient of the function the kernels compute (a row that
    sees no key has uniform weights over the keys, as their _NEG
    convention gives, and contributes dO/Tk to dV only)."""
    b, tq, hq, _ = q.shape
    tk, hk = k.shape[1], k.shape[2]
    group = hq // hk
    f64 = dict(dtype=torch.float64, device=q.device)
    dq = torch.zeros(q.shape, **f64)
    dk = torch.zeros(k.shape, **f64)
    dv = torch.zeros(v.shape, **f64)
    visible = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = k_offset + torch.arange(tk, device=q.device)
        visible = qpos[:, None] >= kpos[None, :]
    blind = ~visible.any(dim=1)
    for bi in range(b):
        for h in range(hq):
            kv = h // group
            qh, gh = q[bi, :, h].double(), g[bi, :, h].double()
            kh, vh = k[bi, :, kv].double(), v[bi, :, kv].double()
            s = (qh @ kh.T) * scale
            s.masked_fill_(~visible, -math.inf)
            p = torch.softmax(s, dim=-1)
            del s
            p[blind] = 1.0 / tk
            dp = gh @ vh.T
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            del dp
            ds.masked_fill_(~visible, 0.0)
            dq[bi, :, h] = (ds @ kh) * scale
            dk[bi, :, kv] += (ds.T @ qh) * scale
            dv[bi, :, kv] += p.T @ gh
            del p, ds
    return {"dq": dq, "dk": dk, "dv": dv}


def witness_readings(device):
    """The bf16 backward kernels and their plain versions against a
    float64 witness (:func:`witness_grads`) on ``WITNESS_SEEDS`` seeds of
    each case of ``WITNESS_CASES`` (the seeds of :func:`extra_seeds`, of
    which the check runs the first ``BWD_EXTRA_SEEDS``): per gradient the
    kernel's and the plain version's max and mean |difference| over
    max|witness| and largest difference in bf16 steps of the witness's
    element, and the kernel against the plain version.  Prints every
    reading and the worst per case; decides nothing."""
    build_phase(("flash_fwd_mma", "flash_bwd_mma"))
    cases = bwd_check_cases()
    worst = {}
    for i, (name, shape, dtype, causal, qo, ko) in enumerate(cases):
        if name not in WITNESS_CASES:
            continue
        for seed in extra_seeds(i, WITNESS_SEEDS):
            args, kw = bwd_inputs(shape, dtype, causal, qo, ko, device, seed)
            got, want = bwd_pair(args, kw, dtype)
            wit = witness_grads(*args[:4], **kw)
            del args
            for grad in ("dq", "dk", "dv"):
                row = {"kernel": readings(got[grad], wit[grad]),
                       "plain": readings(want[grad], wit[grad]),
                       "kernel_vs_plain": readings(got[grad], want[grad])}
                log(f"  {name} seed {seed} {grad}: " + "; ".join(
                    f"{who} max {r['max']:.3e} mean {r['mean']:.3e} "
                    f"top_steps {r['top_steps']:.3g} steps {r['steps']:.3g}"
                    for who, r in row.items()))
                acc = worst.setdefault((name, grad), {
                    who: dict.fromkeys(r, 0.0) for who, r in row.items()})
                for who, r in row.items():
                    for key, x in r.items():
                        acc[who][key] = max(acc[who][key], x)
            del got, want, wit
            torch.cuda.empty_cache()
    log("  worst over the seeds (against the float64 witness; kernel "
        "against plain last):")
    for (name, grad), row in worst.items():
        log(f"    {name} {grad}: " + "; ".join(
            f"{who} max {r['max']:.3e} mean {r['mean']:.3e} top_steps "
            f"{r['top_steps']:.3g} steps {r['steps']:.3g}"
            for who, r in row.items()))
    log(json.dumps({"witness_readings": {
        f"{name} {grad}": row for (name, grad), row in worst.items()}}))
    return 0


def bwd_kernel_name(part, dtype):
    return f"flash_bwd_{part}{'_mma' if dtype == torch.bfloat16 else ''}"


def extra_seeds(index, n):
    """``n`` seeds for the case at ``index`` beyond its own (the index),
    which no case uses as its own: 100 (j + 1) + index."""
    return [100 * (j + 1) + index for j in range(n)]


def bf16_steps(got, ref):
    """|got - ref| element by element in bf16 steps of ref's element (a
    value in [2^(e-1), 2^e) has a step of 2^(e-8)), the element's size
    floored at 2^-8 max|ref| so that a tiny element is held to the step
    of that floor; float64."""
    ref = ref.double()
    diff = (got.double() - ref).abs()
    mag = ref.abs()
    mag = torch.maximum(mag, 2.0 ** -8 * mag.max())
    _, exp = torch.frexp(mag)
    return diff / torch.ldexp(torch.ones_like(mag), exp - 8)


def bf16_step(x):
    """The bf16 step at |x| > 0: 2^(e-8) for |x| in [2^(e-1), 2^e)."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8)


def readings(got, ref):
    """The measures of ``got`` against ``ref``: max and mean |difference|
    over max|ref|, max |difference|, the largest difference in bf16 steps
    of max|ref| (``top_steps``) and in steps of each element
    (:func:`bf16_steps`, ``steps``)."""
    scale = max(ref.double().abs().max().item(), 1e-300)
    diff = (got.double() - ref.double()).abs()
    return {"max": diff.max().item() / scale,
            "mean": diff.mean().item() / scale,
            "max_abs": diff.max().item(),
            "top_steps": diff.max().item() / bf16_step(scale),
            "steps": bf16_steps(got, ref).max().item()}


def within(err, lim):
    """Whether every measure that ``lim`` names is within its limit."""
    return all(err[key] <= lim[key] for key in lim)


def flash_bwd_kernel_phase(device, timed=True, mesh_timings=True):
    """Both backward kernels of each dtype against their plain versions at
    the kernel's own key tile; then (``mesh_timings``)
    :func:`mesh_shape_timings`' backward readings; then (``timed``) the
    bf16 pair timed at the
    training path's shape and the MFU preset's, and the f32 pair at the f32 decode check's
    shape and at the training path's shape, each beside its bound, its
    plain version and the backward of one scaled_dot_product_attention
    call."""
    cases = bwd_check_cases()
    errs_by = {}
    failed = []
    for i, (name, shape, dtype, causal, qo, ko) in enumerate(cases):
        lim = BWD_LIMITS[dtype]
        errs_by[name] = {}
        for seed in (i, *extra_seeds(i, BWD_EXTRA_SEEDS)):
            args, kw = bwd_inputs(shape, dtype, causal, qo, ko, device,
                                  seed)
            got, want = bwd_pair(args, kw, dtype)
            del args
            parts = []
            ok = True
            for grad in ("dq", "dk", "dv"):
                err = readings(got[grad], want[grad])
                finite = bool(torch.isfinite(got[grad].float()).all())
                ok = ok and finite and within(err, lim)
                parts.append(f"{grad} max {err['max']:.3e} mean "
                             f"{err['mean']:.3e} top_steps "
                             f"{err['top_steps']:.3g}"
                             f"{'' if finite else ' NOT FINITE'}")
                worst = errs_by[name].setdefault(grad, err)
                for key in err:
                    worst[key] = max(worst[key], err[key])
            log(f"  {bwd_kernel_name('dkv', dtype)}, "
                f"{bwd_kernel_name('dq', dtype)} {name} seed {seed} "
                f"{list(shape)} {str(dtype)[6:]} causal={causal} "
                f"q_offset={qo} k_offset={ko}: {'; '.join(parts)} (against "
                f"the plain version; limits "
                f"{', '.join(f'{k} {v:g}' for k, v in lim.items())}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name} seed {seed}")
            del got, want
    if failed:
        raise RuntimeError(f"the flash backward kernels disagree with their "
                           f"plain versions on cases {failed}")
    if mesh_timings:
        mesh_shape_timings(device, "bwd")
    if not timed:
        return None

    f32_shape = (F32_DECODE["batch"], F32_DECODE["prompt"],
                 F32_DECODE["prompt"], DECODE_CFG.heads, DECODE_CFG.heads,
                 DECODE_CFG.head_dim)
    timings = [
        # shape, dtype, the cases whose worst readings the entries carry,
        # key suffix
        (cases[0][1], torch.bfloat16, ["path"], ""),
        (f32_shape, torch.float32,
         [c[0] for c in cases if c[2] == torch.float32], ""),
        (cases[0][1], torch.float32, ["path_f32"], "_train_shape"),
        (LARGE_SHAPE, torch.bfloat16, ["large_train"], "_large_shape"),
    ]
    kernels = {}
    for shape, dtype, names, key in timings:
        args, kw = bwd_inputs(shape, dtype, True, 0, 0, device, seed=0)
        plain = dict(block_k=kbwd.kernel_block_k(dtype), **kw)
        fns = {
            "dkv": (lambda: kbwd.flash_bwd_dkv(*args, **kw),
                    lambda: kbwd.flash_bwd_dkv_reference(*args, **plain)),
            "dq": (lambda: kbwd.flash_bwd_dq(*args, **kw),
                   lambda: kbwd.flash_bwd_dq_reference(*args, **plain)),
        }
        # the library yardstick: the backward of one causal
        # scaled_dot_product_attention call on [B, H, T, D], which gives
        # dq, dk and dv together (no one PyTorch call gives dk, dv alone)
        q, k, v, g = (x.transpose(1, 2).contiguous() for x in args[:4])
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        library_ms = time_ms(
            lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
            n=5, repeats=3)
        # the kernels it ran, traced with the forward that builds its
        # graph, as the training profile traces a whole step
        library_names = library_kernels(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q, k, v, is_causal=True),
            (q, k, v), g))
        del q, k, v, g, out
        bounds = bwd_bounds(shape, dtype, True)
        for part, (fn, plain_fn) in fns.items():
            kname = bwd_kernel_name(part, dtype)
            ms = time_ms(fn, n=3, repeats=3, warmup=1)
            plain_ms = time_ms(plain_fn, n=1, repeats=3, warmup=1)
            flops, nbytes, bound_ms, bound_by, route = bounds[part]
            tflops = flops / (ms * 1e-3) / 1e12
            grads = ("dk", "dv") if part == "dkv" else ("dq",)
            worst = {k: max(errs_by[n][gr][k] for n in names
                            for gr in grads)
                     for k in ("max", "mean", "max_abs")}
            log(f"  {kname} at {list(shape)} {str(dtype)[6:]} causal: "
                f"{ms:.4f} ms per launch (plain {plain_ms:.4f} ms; backward "
                f"of scaled_dot_product_attention, dq, dk and dv, "
                f"{library_ms:.4f} ms); {flops:.4e} flops, "
                f"{nbytes / 1e6:.1f} MB; bound {bound_ms:.4f} ms by "
                f"{bound_by} ({route}) at the data-sheet peak "
                f"({tflops:.2f} TFLOP/s achieved); the library call's "
                f"forward and backward ran {library_names or 'not measured'}")
            entry = kernels.setdefault(kname, {
                "name": kname,
                "route": "cuda",
                "source": "mpi4jax_tpu_torch/kernels/csrc/"
                          f"{'flash_bwd_mma' if dtype == torch.bfloat16 else 'flash_bwd'}.cu",
                "replaces": ("mpi4jax_tpu/ops/flash.py:399" if part == "dkv"
                             else "mpi4jax_tpu/ops/flash.py:472"),
                "launches": None,  # filled from the training path phase
                "max_abs_err": worst["max_abs"],
                "max_rel_err": worst["max"],
                "mean_rel_err": worst["mean"],
                "library_call": "backward of scaled_dot_product_attention "
                                "(dq, dk and dv together)",
                "dtype": str(dtype)[6:],
            })
            entry.update({
                f"ms{key}": ms,
                f"plain_ms{key}": plain_ms,
                f"bound_ms{key}": bound_ms,
                f"bound_by{key}": bound_by,
                f"bound_route{key}": route,
                f"library_ms{key}": library_ms,
                f"library_kernels{key}": library_names,
                f"bytes{key}": nbytes,
                f"flops{key}": flops,
                f"tflops{key}": tflops,
                f"shape{key}": list(shape),
            })
        del args
    return list(kernels.values())


class PlainFlash(torch.autograd.Function):
    """Flash attention through the kernels' plain versions, forward and
    backward, on whatever tensors it is given (the training check's
    plain path)."""

    @staticmethod
    def forward(ctx, q, k, v):
        kw = dict(causal=True, scale=1.0 / math.sqrt(q.shape[-1]))
        out, m, l = kflash.flash_attention_reference(
            q, k, v, block_k=kflash.kernel_block_k(q.dtype), with_lse=True,
            **kw)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        return kbwd.flash_bwd_reference(
            q, k, v, out, g, m, l, block_k=kbwd.kernel_block_k(q.dtype),
            **ctx.kw)


def plain_train_attention(q, k, v, *, causal):
    assert causal
    return PlainFlash.apply(q, k, v)


def train_data(cfg, device, seed=0, dtype=torch.bfloat16,
               batch=TRAIN["batch"], seq=TRAIN["seq"]):
    """Parameters of ``dtype`` and a batch of tokens with their
    next-token targets, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, dtype=dtype, device=device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device)
    return params, (tokens, torch.roll(tokens, -1, dims=1))


def loss_and_grads(params, batch, cfg, comm_tp, comm_sp, remat=False):
    """The training step's loss and raw gradients (no update)."""
    leaves = tfm._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    logits, aux = tfm._forward_sharded(params, batch[0], cfg, comm_tp,
                                       comm_sp, remat=remat)
    loss = tfm._ce(logits, batch[1]) + aux
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_path_phase(device, bwd_kernels, flash_kernel, card):
    cfg = TRAIN_CFG
    batch_size, seq = TRAIN["batch"], TRAIN["seq"]
    world = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    dp, tp, sp = world.sub("dp"), world.sub("tp"), world.sub("sp")
    params, batch = train_data(cfg, device)
    n_params = sum(t.numel() for t in tfm._leaves(params))
    # donated, as the bench's step: the peak memory holds one copy of
    # the parameters
    step = tfm.make_global_train_step(dp, tp, sp, cfg, lr=TRAIN_LR,
                                      remat=TRAIN["remat"], donate=True,
                                      device=device)
    before = [t.detach().clone() for t in tfm._leaves(params)]
    torch.cuda.reset_peak_memory_stats(device)
    (params, loss), warm_s = synced_seconds(lambda: step(params, batch))
    losses = [loss.item()]
    log(f"  make_global_train_step: {n_params / 1e6:.1f} M parameters, "
        f"batch {batch_size}, seq {seq}, bf16, attn_impl='flash', "
        f"remat={TRAIN['remat']!r}; "
        f"warm-up step {warm_s:.4f} s, loss {losses[0]:.6f}")

    walls = []
    per_step = []
    for _ in range(TRAIN_TIMED_STEPS):
        reset_launch_counts()
        (params, loss), wall = synced_seconds(lambda: step(params, batch))
        counts = launch_counts()
        per_step.append({kname: counts[kname] for kname in TRAIN_LAUNCHES})
        walls.append(wall)
        losses.append(loss.item())
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"  launches per timed step {per_step}")
    for counts in per_step:
        for kname, n in counts.items():
            want = cfg.layers * TRAIN_LAUNCHES[kname]
            if n != want:
                raise RuntimeError(f"{kname} launched {n} times in one "
                                   f"training step, expected {want}")
    for k in bwd_kernels:
        if TRAIN_LAUNCHES[k["name"]]:
            k["launches"] = sum(c[k["name"]] for c in per_step)
            k["launches_per_step"] = per_step[0][k["name"]]
    flash_kernel["launches_train"] = sum(c["flash_fwd_mma"]
                                         for c in per_step)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses not finite: {losses}")
    changed = [(new != old).float().mean().item()
               for new, old in zip(tfm._leaves(params), before)]
    del before
    if not any(changed):
        raise RuntimeError("the training steps changed no parameter")
    log(f"  losses {losses}; share of elements changed per leaf "
        f"{[round(c, 4) for c in changed]}")

    best = min(walls)
    tokens = batch_size * seq
    model_tflops = 6.0 * n_params * tokens / best / 1e12
    attn_tflops = transformer_train.attention_flops(cfg, batch_size, seq) \
        / best / 1e12
    peak = transformer_train._peak_tflops(device)
    mfu = {}
    if peak:
        mfu = {"mfu_pct": 100.0 * model_tflops / peak,
               "mfu_incl_attn_pct": 100.0 * (model_tflops + attn_tflops)
               / peak}
    kernel_ms = cfg.layers * (
        TRAIN_LAUNCHES["flash_fwd_mma"] * flash_kernel["ms_train_shape"]
        + sum(TRAIN_LAUNCHES[k["name"]] * k["ms"] for k in bwd_kernels))
    log(f"  step {best * 1e3:.4f} ms (best of {TRAIN_TIMED_STEPS}; all "
        f"{[round(w * 1e3, 4) for w in walls]}), {tokens / best:.2f} "
        f"tokens/s, {model_tflops:.4f} model TFLOP/s (6·N·tokens), "
        f"{model_tflops + attn_tflops:.4f} with the causal attention "
        f"scores; MFU {mfu}; the flash kernels {kernel_ms:.4f} ms of it at "
        f"the kernel phases' rates; peak memory {peak_gb:.4f} GB; on {card}")
    del params, step
    worst = train_grad_check(device)
    f32_worst, f32_launches = train_grad_check(device, torch.float32)
    for k in bwd_kernels:
        if not TRAIN_LAUNCHES[k["name"]]:
            k["launches"] = f32_launches[k["name"]]
    return {"step_ms": best * 1e3, "step_ms_all": [w * 1e3 for w in walls],
            "tokens_per_s": tokens / best,
            "model_tflops_per_sec": model_tflops,
            "model_tflops_incl_attn": model_tflops + attn_tflops, **mfu,
            "peak_memory_gb": peak_gb, "losses": losses,
            "warmup_s": warm_s, "grad_check_worst": worst,
            "f32_grad_check_worst": f32_worst,
            "params_m": n_params / 1e6, "remat": TRAIN["remat"]}


class WitnessAttention(torch.autograd.Function):
    """Causal softmax attention in float64, one (batch, query head) at a
    time, its gradient by :func:`witness_grads`: the attention of the
    training gradient's float64 witness (no [B, H, T, T] tensor is held,
    so it runs at the training path's sequence)."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, tq, hq, d = q.shape
        group = hq // k.shape[2]
        scale = 1.0 / math.sqrt(d)
        visible = torch.ones(tq, k.shape[1], dtype=torch.bool,
                             device=q.device).tril()
        out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
        for bi in range(b):
            for h in range(hq):
                s = (q[bi, :, h] @ k[bi, :, h // group].T) * scale
                s.masked_fill_(~visible, -math.inf)
                out[bi, :, h] = torch.softmax(s, dim=-1) @ v[bi, :, h // group]
                del s
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = witness_grads(q, k, v, g, causal=True, scale=ctx.scale,
                              q_offset=0, k_offset=0)
        return grads["dq"], grads["dk"], grads["dv"]


def witness_train_attention(q, k, v, *, causal):
    assert causal
    return WitnessAttention.apply(q.double(), k.double(), v.double())


def _witness_nll_sum(x, head, targets):
    logits = x @ head
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum()


def witness_loss_and_grads(params, batch, cfg, comm_tp, comm_sp,
                           chunk=1024):
    """The float64 witness of :func:`loss_and_grads`: the same loss and
    its gradient computed in float64 from the same (bf16) parameters and
    tokens, attention by :class:`WitnessAttention` and the cross-entropy
    in float64.  Each layer and each ``chunk`` of tokens' logits is
    recomputed in the backward, so the float64 activations of one layer
    or chunk live at a time (at the training preset's width, some
    10 GB)."""
    leaves = [t.detach().double().requires_grad_(True)
              for t in tfm._leaves(params)]
    p64 = tfm.TransformerParams(
        embed=leaves[0], blocks=tfm.BlockParams(*leaves[1:-2]),
        ln_f=leaves[-2], head=leaves[-1])
    tokens, targets = batch
    hidden, aux = tfm._forward_sharded(
        p64, tokens, cfg._replace(attn_impl=witness_train_attention),
        comm_tp, comm_sp, remat=True, return_hidden=True)
    total = aux.double()
    for c0 in range(0, tokens.shape[1], chunk):
        total = total + checkpoint(
            _witness_nll_sum, hidden[:, c0:c0 + chunk], p64.head,
            targets[:, c0:c0 + chunk], use_reentrant=False)
    loss = total / targets.numel()
    return loss.detach(), torch.autograd.grad(loss, leaves)


def grad_readings(kernel, plain, witness=None):
    """The measures of one gradient leaf: the kernel path against the
    plain path (``kp_max``, ``kp_mean``: max and mean |difference| over
    max|plain|) and, given a float64 witness, each path against it
    (``kw_*``, ``pw_*``: over max|witness|) and the kernel path's mean
    difference from it over the plain path's (``ratio``)."""
    k, p = kernel.double(), plain.double()
    p_top = max(p.abs().max().item(), 1e-300)
    kp = (k - p).abs()
    out = {"kp_max": kp.max().item() / p_top,
           "kp_mean": kp.mean().item() / p_top}
    if witness is not None:
        w = witness.double()
        w_top = max(w.abs().max().item(), 1e-300)
        for name, x in (("kw", k), ("pw", p)):
            diff = (x - w).abs()
            out[f"{name}_max"] = diff.max().item() / w_top
            out[f"{name}_mean"] = diff.mean().item() / w_top
        out["ratio"] = out["kw_mean"] / max(out["pw_mean"], 1e-300)
    out["finite"] = bool(torch.isfinite(k).all())
    return out


def train_grad_check(device, dtype=torch.bfloat16):
    """The gradient at 2 layers, kernel path against plain path, leaf by
    leaf, each leaf within ``TRAIN_GRAD_LIMIT`` (bf16) or
    ``F32_GRAD_LIMIT`` (f32) by max|difference| over max|plain|.  bf16:
    at the training preset's width and sequence, on seed 1 and
    ``TRAIN_GRAD_EXTRA_SEEDS`` more (:func:`extra_seeds`), each path also
    read against the float64 witness (:func:`witness_loss_and_grads`),
    and every leaf's kernel-path mean difference from it within
    ``TRAIN_WITNESS_RATIO`` of the plain path's; returns the worst of
    each measure; and the kernel path under each policy of
    ``REMAT_POLICIES``, its loss and every leaf equal bit for bit to the
    kernel path without remat and its mean difference from the witness
    within ``TRAIN_WITNESS_RATIO`` of the plain path's, its launches
    those of ``TRAIN_LAUNCHES`` (the worst of each under ``"remat"``).
    f32: at the decode model's width, batch 2, seq 1024, on seed 1;
    returns the worst reading and the kernel path's launches (each f32
    flash kernel once per layer).  Every seed is read before it
    raises."""
    world = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    tp, sp = world.sub("tp"), world.sub("sp")
    bf16 = dtype == torch.bfloat16
    name = str(dtype)[6:]
    check_cfg = (TRAIN_CFG if bf16 else F32_TRAIN_CFG)._replace(
        layers=TRAIN_CHECK_LAYERS)
    shape = {} if bf16 else F32_TRAIN
    limits = ({"kp_max": TRAIN_GRAD_LIMIT, "ratio": TRAIN_WITNESS_RATIO}
              if bf16 else {"kp_max": F32_GRAD_LIMIT})
    # label, attention, remat
    paths = [("kernel", "flash", False), ("plain", plain_train_attention,
                                          False)]
    policies = [f"remat {policy!r}" for policy in REMAT_POLICIES] \
        if bf16 else []
    if bf16:
        paths.append(("witness", None, False))
        paths += [(label, "flash", policy)
                  for label, policy in zip(policies, REMAT_POLICIES)]
    seeds = (1, *extra_seeds(1, TRAIN_GRAD_EXTRA_SEEDS)) if bf16 else (1,)
    worst = dict.fromkeys(("kp_max", "kp_mean", "kw_max", "kw_mean",
                           "pw_max", "pw_mean", "ratio"), 0.0)
    remat_worst = {label: {"nr_max": 0.0, "ratio": 0.0, "identical": True}
                   for label in policies}
    remat_limits = {"ratio": TRAIN_WITNESS_RATIO}
    remat_launches = {kname: TRAIN_CHECK_LAYERS * n
                      for kname, n in TRAIN_LAUNCHES.items()}
    failed = []
    for seed in seeds:
        grads = {}
        for label, impl, remat in paths:
            params, batch = train_data(check_cfg, device, seed=seed,
                                       dtype=dtype, **shape)
            reset_launch_counts()
            if label == "witness":
                grads[label] = witness_loss_and_grads(params, batch,
                                                      check_cfg, tp, sp)
            else:
                grads[label] = loss_and_grads(
                    params, batch, check_cfg._replace(attn_impl=impl), tp,
                    sp, remat=remat)
            if label == "kernel":
                counts = launch_counts()
            elif remat:
                got = {k: n for k, n in launch_counts().items()
                       if k in remat_launches}
                if got != remat_launches:
                    failed.append((seed, label, f"launches {got}"))
            del params
        torch.cuda.synchronize()
        log(f"  {TRAIN_CHECK_LAYERS}-layer {name} gradient, seed {seed}: "
            f"kernel path launches {counts}; loss "
            + ", ".join(f"{label} {loss.item():.8f}"
                        for label, (loss, _) in grads.items()))
        witness = (grads["witness"][1] if bf16
                   else [None] * len(grads["kernel"][1]))
        for leaf, kg, pg, wg in zip(transformer_names(), grads["kernel"][1],
                                    grads["plain"][1], witness):
            r = grad_readings(kg, pg, wg)
            bad = [key for key, lim in limits.items()
                   if not (r[key] <= lim and r["finite"])]
            for key in worst:
                worst[key] = max(worst[key], r.get(key, 0.0))
            if bad:
                failed.append((seed, leaf, bad))
            log(f"    {name} gradient seed {seed} {leaf}: " + ", ".join(
                f"{key} {x:.3e}" for key, x in r.items() if key != "finite")
                + ("" if r["finite"] else " NOT FINITE")
                + (f" FAIL {bad}" if bad else ""))
        for label in policies:
            # the policy's kernel path against no remat ("nr") and, in
            # the kernel path's place, against the witness
            bad_leaves = []
            if not torch.equal(grads[label][0], grads["kernel"][0]):
                bad_leaves.append("loss")
            top = {"nr_max": 0.0, "ratio": 0.0, "identical": True}
            for leaf, rg, kg, pg, wg in zip(
                    transformer_names(), grads[label][1], grads["kernel"][1],
                    grads["plain"][1], witness):
                r = {"nr_max": grad_readings(rg, kg)["kp_max"],
                     **grad_readings(rg, pg, wg)}
                same = torch.equal(rg, kg)
                top["identical"] = top["identical"] and same
                for key in ("nr_max", "ratio"):
                    top[key] = max(top[key], r[key])
                if not (same and r["finite"] and all(
                        r[key] <= lim for key, lim in remat_limits.items())):
                    bad_leaves.append(leaf)
            if bad_leaves:
                failed.append((seed, label, bad_leaves))
            total = remat_worst[label]
            total["identical"] = total["identical"] and top["identical"]
            for key in ("nr_max", "ratio"):
                total[key] = max(total[key], top[key])
            log(f"    {name} gradient seed {seed}, {label} (kernel path): "
                f"loss {grads[label][0].item():.8f}, worst leaf nr_max "
                f"(against no remat) {top['nr_max']:.3e}, witness ratio "
                f"{top['ratio']:.3e}, bit for bit with no remat "
                f"{top['identical']}"
                + (f" FAIL {bad_leaves}" if bad_leaves else ""))
        del grads
    if not bf16:
        want = {kname: TRAIN_CHECK_LAYERS if kname in (
            "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq") else 0
            for kname in counts}
        if counts != want:
            raise RuntimeError(f"the f32 gradient's launches {counts}, "
                               f"expected {want}")
    log(f"  {TRAIN_CHECK_LAYERS}-layer {name} gradient, kernel vs plain "
        f"path over {len(seeds)} seed(s), worst: " + ", ".join(
            f"{key} {x:.3e}" for key, x in worst.items() if x)
        + f" (limits {limits}) {'FAIL' if failed else 'ok'}")
    for label, top in remat_worst.items():
        log(f"  {TRAIN_CHECK_LAYERS}-layer {name} gradient, {label} over "
            f"{len(seeds)} seed(s), worst: nr_max {top['nr_max']:.3e}, "
            f"ratio {top['ratio']:.3e} (limits {remat_limits}, and bit for "
            f"bit with no remat); bit for bit with no remat on every seed "
            f"{top['identical']}")
    if failed:
        raise RuntimeError(f"the {name} training gradient on the kernel "
                           f"path disagrees with the plain path or with no "
                           f"remat: {failed}")
    return dict(worst, remat=remat_worst) if bf16 else (worst["kp_max"],
                                                       counts)


def bench_training_phase(device, card):
    """The bench's training legs (``bench.training_legs``) at 1 timed
    batch and 1 yardstick burst.  Every launch count is set to 0 just
    before each leg's timed batch and read just after it, and must be
    the leg's launches per layer and step (``BENCH_TRAIN_LEGS``) times
    its layers and timed steps; the large leg's autotuned attention must
    be the flash kernels; every reading a positive finite number.
    Returns the legs' keys and the counts read."""
    counted = {}

    @contextlib.contextmanager
    def timed(leg, steps):
        reset_launch_counts()
        yield
        counted[leg] = (steps, launch_counts())

    keys = port_bench.training_legs(device, batches=1, roofline_reps=1,
                                    timed=timed)
    log(f"  {json.dumps(keys)} on {card}")
    failed = []
    numbers = {key: x for key, x in keys.items()
               if not key.endswith(("_attn_impl", "_mesh"))}
    if not all(math.isfinite(x) and x > 0 for x in numbers.values()):
        failed.append(f"a reading is not a positive finite number: "
                      f"{numbers}")
    if keys["transformer_mesh"] != [1, 1, 1]:
        failed.append(f"the legs ran on the mesh {keys['transformer_mesh']}, "
                      f"not one card's")
    if keys["transformer_large_attn_impl"] != "flash":
        failed.append(f"the large leg's attention is "
                      f"{keys['transformer_large_attn_impl']!r}, not the "
                      f"flash kernels")
    launches = {}
    for leg, (preset, per_layer) in BENCH_TRAIN_LEGS.items():
        steps, counts = counted[leg]
        layers = port_bench.TRAIN_SIZES[preset]["layers"]
        want = {kname: layers * n * steps for kname, n in per_layer.items()}
        got = {kname: counts[kname] for kname in per_layer}
        launches[leg] = {"steps": steps, "layers": layers, "counts": got}
        log(f"  {leg} ({preset}): launches over its {steps} timed steps "
            f"{got}; expected {want}")
        if got != want:
            failed.append(f"{leg} launched {got}, expected {want}")
    if failed:
        raise RuntimeError(f"the bench's training legs: {failed}")
    return dict(keys, launches=launches)


def mesh_comms(comm):
    return comm.sub("dp"), comm.sub("tp"), comm.sub("sp")


@contextlib.contextmanager
def ring_layout(layout):
    """The training step's ring attention with ``layout`` while inside:
    the step itself takes the contiguous layout, as JAX's does."""
    plain = tfm.ring_attention
    if layout not in (None, "contiguous"):
        tfm.ring_attention = functools.partial(plain, layout=layout)
    try:
        yield
    finally:
        tfm.ring_attention = plain


@contextlib.contextmanager
def sync_skipping_sp():
    """A planted fault: the training step's allreduces over sp (the
    gradient sync's and the loss's) leave each rank's own value."""
    plain = tfm.allreduce

    def faulty(x, op=p_ops.SUM, *, comm=None, token=None):
        if comm is not None and comm.axes == ("sp",):
            return x, token
        return plain(x, op, comm=comm, token=token)

    tfm.allreduce = faulty
    try:
        yield
    finally:
        tfm.allreduce = plain


def mesh_batch(batch, sp, layout):
    """The global batch as the ranks see it: zigzag-reordered along the
    sequence for the zigzag layout (the model has no positions but the
    causal mask, and the loss is a mean over tokens, so the reordered
    batch on the zigzag ring is the same loss as the original on one
    rank)."""
    if layout != "zigzag":
        return batch
    return tuple(zigzag_shard(t, sp) for t in batch)


def mesh_train_run(params, batch, cfg, sequence, layout, device, lr,
                   fault=None):
    """One step of ``make_global_train_step`` (remat="names") on four
    thread ranks of a (1, 2, 2) local world on the card, from the full
    ``params`` (every rank cuts its tp shards): ``(loss, gathered full
    parameters, slowest rank's ms)`` of rank 0, held equal on every rank
    unless a ``fault`` is planted."""
    dp, tp, sp = MESH_TRAIN
    batch = mesh_batch(batch, sp, layout)

    def body(comm):
        comm_dp, comm_tp, comm_sp = mesh_comms(comm)
        shards = tfm.shard_params(params, comm_tp)
        step = tfm.make_global_train_step(
            comm_dp, comm_tp, comm_sp, cfg, lr=lr, sequence=sequence,
            remat="names", device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards, loss = step(shards, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return loss, tfm.gather_params(shards, comm_tp), wall

    with ring_layout(layout), (fault or contextlib.nullcontext)():
        runs = distributed.local_world(
            dp * tp * sp, body, axes=(("dp", "tp", "sp"), MESH_TRAIN),
            deadline=600.0)
    loss, full, _ = runs[0]
    for rank, (l, f, _) in enumerate(runs[1:] if fault is None else [], 1):
        if not (torch.equal(l, loss) and all(
                torch.equal(a, b) for a, b in zip(tfm._leaves(f),
                                                  tfm._leaves(full)))):
            raise RuntimeError(f"rank {rank} of the mesh holds another "
                               f"loss or other parameters")
    return loss, full, max(w for *_, w in runs) * 1e3


def mesh_readings(loss, full, ref_loss, ref_full, p0):
    """The loss's relative difference and, per leaf, max|difference| of
    the updated parameters over max|one-rank update| (the update is the
    gradient at ``MESH_CHECK_LR``)."""
    out = {"loss": abs(float(loss[0]) - float(ref_loss[0]))
           / abs(float(ref_loss[0]))}
    for name, got, want, start in zip(transformer_names(),
                                      tfm._leaves(full),
                                      tfm._leaves(ref_full), p0):
        got, want = got.detach().float(), want.detach().float()
        scale = float((want - start.float()).abs().max())
        out[name] = float((got - want).abs().max()) / max(scale, 1e-30)
    return out


def mesh_train_phase(device, kernels, card):
    """The transformer's training step on four gloo thread ranks of the
    (1, 2, 2) mesh on one card (``MESH_TRAIN_CFG``: the long preset's
    width at 2 layers), remat="names", for each scheme of
    ``MESH_SCHEMES``: in f32 the loss and every updated leaf against the
    one-rank step on the same global batch (dense attention), within
    ``MESH_TRAIN_LIMIT``, and a planted fault's readings beside them;
    then one bf16 step per scheme with the launch counts set to 0 just
    before and read just after: Ulysses 2 x layers flash forwards and
    layers of each backward kernel a rank, the ring none."""
    cfg = MESH_TRAIN_CFG
    dp, tp, sp = MESH_TRAIN
    ranks = dp * tp * sp
    b, s = MESH_TRAIN_BATCH * dp, MESH_TRAIN_SEQ * sp
    params, batch = train_data(cfg, device, seed=3, dtype=torch.float32,
                               batch=b, seq=s)
    p0 = [t.detach().clone() for t in tfm._leaves(params)]
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    ref_step = tfm.make_global_train_step(
        *mesh_comms(one), cfg._replace(attn_impl="xla"), lr=MESH_CHECK_LR,
        remat="names", device=device)
    ref_full = tfm.shard_params(params, one.sub("tp"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_full, ref_loss = ref_step(ref_full, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    log(f"  one rank (dense attention, f32): loss {float(ref_loss[0]):.6f}, "
        f"{ref_ms:.1f} ms")
    record = {"mesh": list(MESH_TRAIN), "layers": cfg.layers,
              "batch": b, "seq": s, "one_rank_ms": ref_ms, "schemes": {}}
    failed = []
    runs = [(name, seq_, layout, None) for name, seq_, layout in MESH_SCHEMES]
    runs.append(("fault_sync_skips_sp", "ring", "contiguous",
                 sync_skipping_sp))
    for name, sequence, layout, fault in runs:
        attn = "flash" if sequence == "ulysses" else "xla"
        loss, full, ms = mesh_train_run(
            params, batch, cfg._replace(attn_impl=attn), sequence, layout,
            device, MESH_CHECK_LR, fault)
        read = mesh_readings(loss, full, ref_loss, ref_full, p0)
        worst = max(read.values())
        ok = worst <= MESH_TRAIN_LIMIT
        planted = fault is not None
        log(f"  {name} (f32, {sequence}"
            + (f", {layout}" if layout else "") + f", attention {attn}): "
            f"loss {float(loss[0]):.6f}, the slowest rank {ms:.1f} ms; "
            f"largest reading {worst:.3e} (limit {MESH_TRAIN_LIMIT:g}) "
            + ("planted fault: " + ("FAIL (passed)" if ok else "caught")
               if planted else ("ok" if ok else "FAIL")))
        log(f"    readings: { {k: f'{v:.2e}' for k, v in read.items()} }")
        record["schemes"][name] = {"readings": read, "worst": worst,
                                   "ms": ms}
        if ok == planted:
            failed.append(name)
        del full

    # one bf16 step per scheme, its flash launches counted
    params16, batch16 = train_data(cfg, device, seed=4, dtype=torch.bfloat16,
                                   batch=b, seq=s)
    for name, sequence, layout in MESH_SCHEMES:
        want = (dict(TRAIN_LAUNCHES) if sequence == "ulysses"
                else dict.fromkeys(TRAIN_LAUNCHES, 0))
        want = {k: v * cfg.layers * ranks for k, v in want.items()}
        reset_launch_counts()
        loss, _, ms = mesh_train_run(
            params16, batch16, cfg._replace(attn_impl="flash"), sequence,
            layout, device, TRAIN_LR)
        got = {k: launch_counts()[k] for k in want}
        ok = got == want and bool(torch.isfinite(loss).all())
        log(f"  {name} (bf16): loss {float(loss[0]):.4f}, the slowest rank "
            f"{ms:.1f} ms; launches over {ranks} ranks {got} (want {want}) "
            f"{'ok' if ok else 'FAIL'}")
        record["schemes"][name]["bf16_launches"] = got
        record["schemes"][name]["bf16_ms"] = ms
        if not ok:
            failed.append(f"{name} bf16")
    for kern in kernels:
        if kern["name"] in TRAIN_LAUNCHES:
            kern["launches_mesh_ulysses"] = record["schemes"]["ulysses"][
                "bf16_launches"][kern["name"]]
    log(f"  four thread ranks on one card over gloo (a correctness rig; "
        f"times are readings, host staging included), on {card}")
    if failed:
        raise RuntimeError(f"the mesh training checks failed: {failed}")
    return record


def mesh_decode_tokens(comm, params, prompts, device):
    """The greedy decode of ``prompts`` (global) at ``MESH_DECODE_RUN``'s
    length on this rank's tp shards (``params`` full), on the decoder's
    ``(dp, tp)`` mesh ``comm``: ``(tokens, captures, replays)``."""
    comm_dp, comm_tp = comm.sub("dp"), comm.sub("tp")
    decode = tfm.make_global_decode(
        comm_dp, comm_tp, DECODE_CFG, MESH_DECODE_RUN["max_len"],
        device=device)
    shards = tfm.shard_params(params, comm_tp)
    first = decode(shards, prompts)
    again = decode(shards, prompts)  # the graphs' replays, where captured
    if not torch.equal(first, again):
        raise RuntimeError("a second decode gave other tokens")
    return again, decode.captures, decode.replays


def mesh_decode_inputs(device):
    gen = torch.Generator(device=device).manual_seed(11)
    params = tfm.init_params(DECODE_CFG, generator=gen, device=device)
    prompts = torch.randint(
        0, DECODE_CFG.vocab, (MESH_DECODE_RUN["batch"],
                              MESH_DECODE_RUN["prompt"]),
        generator=gen, device=device, dtype=torch.int32)
    return params, prompts


def mesh_decode_reference(device):
    """The one-rank decode's tokens and the (2, 2) gloo local world's on
    the card (eager), which must agree."""
    params, prompts = mesh_decode_inputs(device)
    one = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    want, _, _ = mesh_decode_tokens(one, params, prompts, device)
    runs = distributed.local_world(
        MESH_DECODE[0] * MESH_DECODE[1],
        lambda comm: mesh_decode_tokens(comm, params, prompts, device),
        axes=(("dp", "tp"), MESH_DECODE), deadline=300.0)
    for rank, (got, captures, _) in enumerate(runs):
        if captures or not torch.equal(got, want):
            raise RuntimeError(
                f"rank {rank} of the (2, 2) gloo decode: {captures} graphs, "
                f"tokens {'equal' if torch.equal(got, want) else 'differ'}")
    return want


def mesh_decode_phase(device):
    """The decoder on the (2, 2) mesh of four gloo thread ranks on the
    card (its steps eager), greedy, f32, at the decode model's width:
    every rank's tokens equal the one-rank decoder's."""
    t0 = time.perf_counter()
    want = mesh_decode_reference(device)
    log(f"  tokens {list(want.shape)} equal on every rank of the (2, 2) "
        f"gloo world and on one rank ({time.perf_counter() - t0:.1f} s)")
    return {"mesh": list(MESH_DECODE), **MESH_DECODE_RUN, "equal": True}


def device_split(per_kernel):
    """Device ms of a trace by class: the flash kernels, cuBLAS GEMMs,
    NCCL, and the rest (elementwise and reductions), by kernel name."""
    split = dict.fromkeys(("flash", "gemm", "nccl", "other"), 0.0)
    for name, (ms, _) in per_kernel.items():
        low = name.lower()
        cls = ("nccl" if "nccl" in low else "flash" if "flash_" in low
               else "gemm" if any(k in low for k in (
                   "gemm", "nvjet", "xmma", "cutlass", "cublas")) else "other")
        split[cls] += ms
    return split


def nccl_train_phase(comm, device, rank):
    """The long preset as written on the (1, 2, 2) mesh over NCCL, for
    the ring and Ulysses: ``run`` (the bench's training leg), then one
    step of each traced on rank 0."""
    out = {}
    for sequence in ("ring", "ulysses"):
        rec = transformer_train.preset_run(
            TRAIN, bf16=True, batches=1, device=device, comm=comm,
            sequence=sequence)
        if not math.isfinite(rec["loss"]) or rec["mesh"] != list(MESH_TRAIN):
            raise RuntimeError(f"rank {rank}: the {sequence} step: {rec}")
        out[sequence] = {k: rec[k] for k in (
            "step_ms", "value", "peak_memory_gb", "peak_memory_gb_ranks",
            "mfu_pct", "loss", "steps_per_batch", "mesh", "devices")}
        out[sequence]["tokens_per_s_per_card"] = rec["value"] / rec["devices"]
        log(f"rank {rank}: long preset on {rec['mesh']} ({sequence}): "
            f"{rec['step_ms']:.1f} ms a step, {rec['value']:.1f} tokens/s "
            f"({rec['value'] / rec['devices']:.1f} a card), peak memory "
            f"{rec['peak_memory_gb_ranks']} GB")
        torch.cuda.empty_cache()
    # one step of each under torch.profiler on rank 0
    world = comm.world.comm((("dp", "tp", "sp"), MESH_TRAIN))
    comm_dp, comm_tp, comm_sp = mesh_comms(world)
    cfg = TRAIN_CFG
    b, s = TRAIN["batch"] * MESH_TRAIN[0], TRAIN["seq"] * MESH_TRAIN[2]
    for sequence in ("ring", "ulysses"):
        params, batch = train_data(cfg, device, batch=b, seq=s)
        params = tfm.shard_params(params, comm_tp)
        step = tfm.make_global_train_step(
            comm_dp, comm_tp, comm_sp, cfg, lr=TRAIN_LR, sequence=sequence,
            remat=TRAIN["remat"], donate=True, device=device)
        step(params, batch)  # warm
        torch.cuda.synchronize()
        if rank == 0:
            per_kernel, span = device_trace(lambda: step(params, batch))
            split = device_split(per_kernel)
            busy = sum(split.values())
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
            log(f"rank 0: one traced {sequence} step: device busy "
                f"{busy:.1f} ms over a {span:.1f} ms timeline; by class "
                f"{ {k: round(v, 2) for k, v in split.items()} } ms")
            for name, (ms, count) in top:
                log(f"    {ms:.2f} ms, {count} launches: {name[:90]}")
            out[sequence]["trace"] = {
                "busy_ms": busy, "span_ms": span, "split_ms": split,
                "top": [(name[:90], ms, count)
                        for name, (ms, count) in top]}
        else:
            step(params, batch)
            torch.cuda.synchronize()
        del params, step
        torch.cuda.empty_cache()
    return out


def nccl_pp_phase(comm, device, rank):
    """The bench's pp mode (``PP_CFG``, ``PP_RUN``, GPipe) across the
    world on the JAX bench's (dp, pp) = (1, 4) over NCCL, f32 and bf16,
    3 timed batches: the record's step ms (the slowest rank's),
    tokens/s in all and a card, each rank's peak memory; then one step
    traced on rank 0 (device ms by kernel class)."""
    cfg = PP_CFG
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        rec = transformer_train.run(
            batch=PP_RUN["batch"], seq=PP_RUN["seq"], layers=cfg.layers,
            d_model=cfg.d_model, heads=cfg.heads, kv_heads=cfg.kv_heads,
            d_ff=cfg.d_ff, vocab=cfg.vocab, bf16=dtype == torch.bfloat16,
            batches=3, mode="pp", micro=PP_RUN["micro"], device=device,
            comm=comm)
        if not math.isfinite(rec["loss"]) or rec["mesh"] != list(PP_MESH):
            raise RuntimeError(f"rank {rank}: the pp mode ({name}): {rec}")
        out[name] = {k: rec[k] for k in (
            "step_ms", "value", "peak_memory_gb", "peak_memory_gb_ranks",
            "loss", "steps_per_batch", "mesh", "devices", "n_micro",
            "layers")}
        out[name]["tokens_per_s_per_card"] = rec["value"] / rec["devices"]
        log(f"rank {rank}: the bench's pp mode on {rec['mesh']} ({name}): "
            f"{rec['step_ms']:.1f} ms a step, {rec['value']:.1f} tokens/s, "
            f"peak memory {rec['peak_memory_gb_ranks']} GB")
        torch.cuda.empty_cache()
    # one f32 step under torch.profiler on rank 0
    world = comm.world.comm((("dp", "pp"), PP_MESH))
    comm_dp, comm_pp = world.sub("dp"), world.sub("pp")
    params, batch = train_data(cfg, device, dtype=torch.float32,
                               batch=PP_RUN["batch"], seq=PP_RUN["seq"])
    params = ppt.shard_params(params, comm_pp)
    step = ppt.make_global_train_step(comm_dp, comm_pp, cfg,
                                      PP_RUN["micro"], lr=TRAIN_LR,
                                      device=device)
    step(params, batch)
    torch.cuda.synchronize()
    if rank == 0:
        per_kernel, span = device_trace(lambda: step(params, batch))
        split = device_split(per_kernel)
        busy = sum(split.values())
        log(f"rank 0: one traced f32 pp step: device busy {busy:.1f} ms "
            f"over a {span:.1f} ms timeline; by class "
            f"{ {k: round(v, 2) for k, v in split.items()} } ms")
        out["trace_rank0_float32"] = {"busy_ms": busy, "span_ms": span,
                                      "split_ms": split}
    else:
        step(params, batch)
        torch.cuda.synchronize()
    return out


def nccl_decode_phase(comm, device, rank, want):
    """The decoder on the (2, 2) mesh over NCCL, its generate steps CUDA
    graphs that hold the tp allreduces: tokens equal to the gloo world's
    (``want``); then the bench's decode legs on the mesh."""
    world = comm.world.comm((("dp", "tp"), MESH_DECODE))
    params, prompts = mesh_decode_inputs(device)
    got, captures, replays = mesh_decode_tokens(world, params, prompts,
                                                device)
    if not captures or not torch.equal(got, want):
        raise RuntimeError(
            f"rank {rank}: the NCCL decode captured {captures} graphs, "
            f"tokens {'equal' if torch.equal(got, want) else 'differ'}")
    log(f"rank {rank}: NCCL decode on (2, 2): {captures} graphs, {replays} "
        f"replayed steps, tokens equal to the gloo world's")
    legs = {}
    for leg, key, kw in port_bench.DECODE_LEGS:
        rec = transformer_decode.run_decode(
            **port_bench.DECODE_MODEL, **kw, bf16=True, batches=1,
            device=device, comm=comm)
        legs[key] = {"value": rec["value"], "wall_s": rec["wall_s"],
                     "batch": rec["batch"], "mesh": rec["mesh"]}
        log(f"rank {rank}: {key} on {rec['mesh']}: {rec['value']:.1f} "
            f"generated tokens/s (global batch {rec['batch']})")
    return {"captures": captures, "replays": replays, "legs": legs}


def transformer_names():
    return ["embed", *tfm.BlockParams._fields, "ln_f", "head"]


def train_profile_phase(device, train):
    """Device time by kernel over one training step under
    torch.profiler, and the idle share against the untraced step."""
    from torch.autograd import DeviceType

    world = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    params, batch = train_data(TRAIN_CFG, device)
    step = tfm.make_global_train_step(
        world.sub("dp"), world.sub("tp"), world.sub("sp"), TRAIN_CFG,
        lr=TRAIN_LR, remat=TRAIN["remat"], donate=True, device=device)
    step(params, batch)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        total, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (total + e.time_range.elapsed_us() / 1e3,
                              count + 1)
    if not per_kernel:
        log("  the profiler recorded no device activity: not measured")
        return None
    busy = sum(ms for ms, _ in per_kernel.values())
    launches = sum(c for _, c in per_kernel.values())
    flash = {name: sum(ms for kname, (ms, _) in per_kernel.items()
                       if f"{name}_kernel<" in kname)
             for name in TRAIN_LAUNCHES}
    idle = 1 - busy / train["step_ms"]
    log(f"  device busy {busy:.4f} ms in {launches} launches of a "
        f"{train['step_ms']:.4f} ms untraced step (idle share {idle:.4f}); "
        f"flash kernels, ms {flash}, share of device time "
        f"{ {name: round(ms / busy, 4) for name, ms in flash.items()} }")
    for kname, (ms, count) in sorted(per_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:8]:
        log(f"    {ms:.4f} ms, {count} launches: {kname[:90]}")
    return {"device_ms": busy, "launches": launches, "idle_share": idle,
            "flash_ms": flash,
            "flash_share": {name: ms / busy for name, ms in flash.items()}}


def sw_check(device):
    """Phase 2's sw_main checks at the bench configuration, untimed."""
    cfg = sw.SWConfig().bench_size()
    _, inputs, geometry, iy = sw_bench_inputs(cfg, MeshComm(), device)
    sw_main_checks(inputs, geometry, iy, device)


def run_checks(device, parts, mesh_timings=True):
    """The kernel checks named in ``parts`` (``fwd``: phase 5's cases,
    ``bwd``: phase 8's, ``grad``: the training path's 2-layer gradient,
    ``sw``: phase 2's sw_main checks; ``ops``: phase 4b''s op cases, no
    kernel; ``mesh``: phase 10c's transformer across thread ranks;
    ``proc``: phase 11's launcher jobs, no kernel; ``mlp``: phase 12's
    MLP steps, no kernel; ``moe``: phase 13; ``pp``: phase 14, no
    kernel; ``serve``: phase 15, no kernel; ``elastic``: phase 16, the
    shallow-water kernels), after building the kernels they need.  The phases' own
    timings are left out; ``fwd`` and ``bwd`` time the bf16 kernels at
    the meshes' shapes (:func:`mesh_shape_timings`) unless
    ``mesh_timings`` is False (``--no-timings``: the copies of
    ``--fault-readings``).
    Every check runs and prints its readings even when an earlier one
    failed; returns 1 when any failed."""
    sources = ((("sw_step",) if {"sw", "elastic"} & set(parts) else ())
               + (FLASH_SOURCES
                  if set(parts) - {"sw", "ops", "proc", "mlp", "pp",
                                   "serve", "elastic"}
                  else ()))
    if sources:
        build_phase(sources)
    checks = {
        "ops": lambda: multirank_ops_phase(device),
        "sw": lambda: sw_check(device),
        "fwd": lambda: flash_kernel_phase(device, timed=False,
                                          mesh_timings=mesh_timings),
        "bwd": lambda: flash_bwd_kernel_phase(device, timed=False,
                                              mesh_timings=mesh_timings),
        "grad": lambda: (train_grad_check(device),
                         train_grad_check(device, torch.float32)),
        "mesh": lambda: (mesh_train_phase(device, [], card_line()),
                         mesh_decode_phase(device)),
        "proc": lambda: proc_phase(device, card_line()),
        "mlp": lambda: mlp_mesh_phase(device, card_line()),
        "moe": lambda: moe_phase(device, [], card_line()),
        "pp": lambda: pp_phase(device, [], card_line()),
        "serve": lambda: serve_phase(device, [], card_line()),
        "elastic": lambda: elastic_phase(device, [], card_line()),
    }
    failed = []
    for part in parts:
        try:
            checks[part]()
        except RuntimeError as e:
            log(f"  check {part} failed: {e}")
            failed.append(part)
    return 1 if failed else 0


def sass_counts(lib_path, kernel):
    """Instructions of ``kernel`` in ``lib_path`` as cuobjdump -sass
    lists them (static: a loop's body once): all, and those of each
    opcode that sw_main's design counts (MUFU.RCP: one per IEEE
    division, and one in the slow path they share; global and shared
    loads, stores, cp.async and shuffles).
    None where the toolkit has no cuobjdump."""
    tool = pathlib.Path(shutil.which("cuobjdump")
                        or pathlib.Path(_build._nvcc()).parent / "cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    body = re.split(r"\n\s*Function : ", out)
    code = next((b for b in body if kernel in b.split("\n", 1)[0]), "")
    ops = re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", code)
    counts = {"all": len(ops)}
    for op in ("MUFU.RCP", "LDG", "LDS", "STG", "LDGSTS", "SHFL"):
        counts[op] = sum(o == op or o.startswith(op + ".") for o in ops)
    return counts


def sw_forms(device, sources):
    """Build the tree's sw_step.cu and each of ``sources`` (another form
    of sw_main, such as an earlier commit's), one nvcc each, all at
    once; hold every form's sw_main to the plain version bit for bit at
    the bench shape for both first_step values; then time them in turns
    at the bench shape's AB2 launch (CUDA events over ``TIMED_LAUNCHES``
    launches, 5 rounds of every form in turn, the median), with ptxas's
    registers and spills and the SASS opcode counts.  Each form runs
    through the wrapper ``sw_step.sw_main`` with its library in place of
    the tree's.  Returns 1 when a form differs from the plain version."""
    work = pathlib.Path(tempfile.mkdtemp(prefix="sw_forms_"))
    try:
        libs = {"tree": _build.library_dir("sw_step") / "libsw_step.so"}
        for i, src in enumerate(sources):
            (work / f"lib_{i}").mkdir()
            libs[str(src)] = work / f"lib_{i}" / "libsw_step.so"
        with ThreadPoolExecutor(len(libs)) as pool:
            futures = [pool.submit(sw_step._library)] + [
                pool.submit(_build._compile, "sw_step", src,
                            libs[str(src)].parent, libs[str(src)])
                for src in sources]
            for f in futures:
                f.result()
        library = sw_step._library
        tree_lib = library()
        cfg = sw.SWConfig().bench_size()
        _, inputs, geometry, iy = sw_bench_inputs(cfg, MeshComm(), device)
        rows, cols = inputs[0].shape

        def launcher(lib, first_step):
            def launch():
                sw_step._library = lambda: lib
                try:
                    return sw_step.sw_main(*inputs, iy=iy,
                                           first_step=first_step, **geometry)
                finally:
                    sw_step._library = library
            return launch

        launches, failed = {}, []
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for fn in ("sw_main_launch", "sw_step_error_string"):
                getattr(lib, fn).argtypes = getattr(tree_lib, fn).argtypes
                getattr(lib, fn).restype = getattr(tree_lib, fn).restype
            for first_step in (True, False):
                got = launcher(lib, first_step)()
                want = sw_step.sw_main_reference(
                    *inputs, iy=iy, first_step=first_step, **geometry)
                torch.cuda.synchronize()
                if not all(torch.equal(w, g) for w, g in zip(want, got)):
                    failed.append(f"{name} first_step={first_step}")
            launches[name] = launcher(lib, False)
        times = {name: [] for name in libs}
        for _ in range(5):
            for name, launch in launches.items():
                times[name].append(time_ms(launch, repeats=1))
        nbytes = 12 * rows * cols * 4
        readings = {}
        for name, path in libs.items():
            ms = statistics.median(times[name])
            ptxas = ptxas_report(path.parent / "build.log")
            regs = [r for r in ptxas if r[0] == "sw_main_kernel"][0][2:]
            sass = sass_counts(path, "sw_main_kernel")
            readings[name] = {"ms": ms, "registers": regs[0],
                              "spill_stores": regs[1],
                              "spill_loads": regs[2], "sass": sass}
            verdict = ("DIFFERS from the plain version"
                       if any(f.startswith(name + " ") for f in failed)
                       else "bit-identical to the plain version")
            log(f"  sw_main form {name}: {ms:.4f} ms (runs "
                f"{', '.join(f'{x:.4f}' for x in times[name])}), "
                f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, {regs[0]} "
                f"registers, spill stores {regs[1]} bytes, spill loads "
                f"{regs[2]} bytes, {verdict}; SASS {sass}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"sw_forms": readings, "failed": failed,
                    "card": card_line()}))
    return 1 if failed else 0


def fault_readings():
    """The kernel checks on this tree and on copies of it with one
    planted fault each (``FAULT_PLANS``), all at once (one process each);
    prints every reading.  A copy with a fault of ``SW_FAULTS`` (in
    ``sw_step.cu``) runs the sw_main checks; one with a fault of
    ``FLASH_FAULTS`` (in ``flash_fwd_mma.cu``) or of
    ``F32_FLASH_FAULTS`` (in ``flash_fwd.cu``) the forward checks, the
    bf16 ``diag_tile`` one also the 2-layer training gradients; one with
    a fault of ``BWD_FAULTS`` (in ``flash_bwd.cu``) or of
    ``BWD_MMA_FAULTS`` or ``BWD_MMA_READINGS`` (in ``flash_bwd_mma.cu``)
    the backward checks; the tree itself all four.  Exit 0 when the
    sound tree passes and every fault of the five fault dictionaries
    fails (the copies of ``BWD_MMA_READINGS`` are read, not judged)."""
    root = pathlib.Path(__file__).resolve().parent
    work = pathlib.Path(tempfile.mkdtemp(prefix="kernel_faults_"))
    plans = [(prefix + name, source, edit,
              "fwd,grad" if prefix + name == "fwd_diag_tile" else parts)
             for prefix, source, faults, parts, _ in FAULT_PLANS
             for name, edit in faults.items()]
    read_only = {prefix + name
                 for prefix, _, faults, _, judged in FAULT_PLANS
                 if not judged for name in faults}
    trees = {"sound": (root, "fwd,bwd,grad,sw")}
    try:
        for name, source, (old, new), parts in plans:
            tree = work / name
            shutil.copytree(root / "mpi4jax_tpu_torch",
                            tree / "mpi4jax_tpu_torch",
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(root / "chip_smoke.py", tree / "chip_smoke.py")
            src = tree / "mpi4jax_tpu_torch/kernels/csrc" / source
            text = src.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} not found once")
            src.write_text(text.replace(old, new))
            trees[name] = (tree, parts)
        env = {**os.environ, "PYTHONPATH": ""}
        procs = {
            name: subprocess.Popen(
                [sys.executable, "chip_smoke.py", "--check", parts,
                 "--no-timings"],
                cwd=tree, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for name, (tree, parts) in trees.items()
        }
        codes, failed = {}, {}
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=1500)
            codes[name] = proc.returncode
            failed[name] = re.findall(r"check (\w+) failed", out)
            log(f"tree {name}, checks {trees[name][1]} (exit "
                f"{proc.returncode}):")
            for line in out.splitlines():
                if any(word in line for word in ("flash_", "sw_main",
                                                 "gradient", "check",
                                                 "Error")):
                    log(f"  {line.strip()}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = codes["sound"] == 0 and all(
        code != 0 for name, code in codes.items()
        if name != "sound" and name not in read_only) and (
        "grad" in failed["fwd_diag_tile"])
    log(json.dumps({"fault_readings": codes, "failed_checks": failed,
                    "ok": ok}))
    return 0 if ok else 1


def main(argv):
    if argv[:1] == ["--proc-rank"]:
        return proc_rank(argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # full-precision f32 products everywhere (PyTorch's defaults, stated):
    # the plain versions' f32 matmuls are then full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == ["--fault-readings"]:
        return fault_readings()
    if argv == ["--witness-readings"]:
        return witness_readings(device)
    if len(argv) in (2, 3) and argv[0] == "--check" and set(
            argv[1].split(",")) <= {"fwd", "bwd", "grad", "sw", "ops",
                                    "mesh", "proc", "mlp", "moe",
                                    "pp", "serve", "elastic"} and argv[2:] in (
            [], ["--no-timings"]):
        return run_checks(device, argv[1].split(","),
                          mesh_timings=argv[2:] == [])
    if argv[:1] == ["--sw-forms"] and len(argv) > 1:
        return sw_forms(device, [pathlib.Path(a) for a in argv[1:]])
    if len(argv) in (2, 3) and argv[0] == "--nccl-world" and argv[2:] in (
            [], ["pp"]):
        return nccl_world(int(argv[1]), only_pp=argv[2:] == ["pp"])
    if argv in (["--nccl-rank"], ["--nccl-rank", "pp"]):
        return nccl_rank(only_pp=argv[1:] == ["pp"])
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"card: {torch.cuda.get_device_name(0)} ({card})")
    t_all = time.perf_counter()

    log("phase build")
    ptxas = build_phase(bridge=True)

    cfg = sw.SWConfig().bench_size()
    comm = MeshComm()
    log(f"phase kernels, shallow water ({cfg.ny}x{cfg.nx}, ghost "
        f"{cfg.ghost}, one rank)")
    copy_rate = copy_bytes_per_s(device)
    log(f"  device-to-device copy: {copy_rate / 1e9:.1f} GB/s "
        f"(read + write)")
    kernels, state0 = kernel_phase(cfg, comm, device, copy_rate)

    log("phase path, shallow water (make_solver, 0.1 model days)")
    path = path_phase(cfg, comm, device, kernels, state0, card)

    log("phase profile, shallow water (one graph replay of 25 steps "
        "under torch.profiler)")
    profile = profile_phase(cfg, comm, state0, path["step_ms"], kernels)
    del state0

    log(f"phase schedules, shallow water (ghost 1, 2, 4 at {cfg.ny}x"
        f"{cfg.nx}, 25-step graphs; bfloat16 at ghost 1 and 4)")
    schedules = schedules_phase(cfg, comm, device)

    py, px = MULTIRANK_GRID
    log(f"phase multi-rank, shallow water ({py}x{px} ranks as threads of "
        f"this process on one card, backend gloo, CUDA tensors staged "
        f"through host memory; {cfg.ny}x{cfg.nx} in {cfg.ny // py}x"
        f"{cfg.nx // px} blocks, ghost {cfg.ghost}, {MULTIRANK_STEPS} "
        f"steps)")
    multirank = multirank_phase(cfg, device, kernels, card)

    log("phase bench (python -m mpi4jax_tpu_torch.bench --quick, in "
        "process)")
    bench_record = port_bench.run_bench(quick=True)
    log(json.dumps(bench_record))

    log("phase kernels, flash attention (forward)")
    f32_kernel, flash_kernel = flash_kernel_phase(device)
    kernels.extend((f32_kernel, flash_kernel))

    log(f"phase path, decode (batch {LONG['batch']}, prompt "
        f"{LONG['prompt']}, max_len {LONG['max_len']}, bf16, flash prefill, "
        f"kv_bucket {LONG['kv_bucket']})")
    decode_path, bf16_run = decode_path_phase(device, flash_kernel,
                                              f32_kernel, copy_rate)

    log("phase profile, decode (one decode call under torch.profiler)")
    decode_profile = decode_profile_phase(*bf16_run, decode_path)
    del bf16_run

    log("phase short-prompt decode (the bench's batch-16 legs: prompt "
        f"{port_bench.DECODE_MODEL['prompt']}, max_len "
        f"{port_bench.DECODE_MODEL['max_len']}, bf16, run_decode(batches=1))")
    short_decode = short_decode_phase(device)

    log("phase kernels, flash backward")
    bwd_kernels = flash_bwd_kernel_phase(device)
    kernels.extend(bwd_kernels)

    log(f"phase path, train (long-context preset: {TRAIN_CFG.layers} "
        f"layers, d_model {TRAIN_CFG.d_model}, batch {TRAIN['batch']}, seq "
        f"{TRAIN['seq']}, bf16, flash attention, remat={TRAIN['remat']!r})")
    train = train_path_phase(device, bwd_kernels, flash_kernel, card)

    log("phase profile, train (one step under torch.profiler)")
    train_profile = train_profile_phase(device, train)

    log("phase bench training legs (bench.training_legs: small, matmul "
        "yardstick, large, long; 1 timed batch and 1 yardstick burst each)")
    bench_training = bench_training_phase(device, card)

    log(f"phase multi-rank transformer, training (four thread ranks on one "
        f"card over gloo, (dp, tp, sp) = {MESH_TRAIN}; d_model "
        f"{MESH_TRAIN_CFG.d_model}, {MESH_TRAIN_CFG.layers} layers, batch "
        f"{MESH_TRAIN_BATCH}, seq {MESH_TRAIN_SEQ} a sp rank, "
        f"remat='names'; ring, zigzag ring, Ulysses)")
    mesh_train = mesh_train_phase(device, kernels, card)

    log(f"phase multi-rank transformer, decode (four thread ranks on one "
        f"card over gloo, (dp, tp) = {MESH_DECODE}; the decode model in "
        f"f32, greedy, {MESH_DECODE_RUN})")
    mesh_decode = mesh_decode_phase(device)

    log(f"phase proc tier (launcher jobs of {PROC_RANKS} ranks on one card "
        f"over the native bridge; CUDA tensors staged through host memory)")
    proc = proc_phase(device, card)

    log(f"phase MLP steps across ranks (models/train.py: "
        f"make_global_train_step and the ZeRO step on a {MLP_MESH} (dp, tp) "
        f"local world of gloo thread ranks on one card, against the same "
        f"world on the CPU)")
    mlp_mesh = mlp_mesh_phase(device, card)

    log(f"phase MoE transformer (the bench's moe model, {MOE_CFG.layers} "
        f"layers, {MOE_CFG.experts} experts, batch {MOE_RUN['batch']}, seq "
        f"{MOE_RUN['seq']}, f32 then bf16; held at {MOE_CHECK_LAYERS} "
        f"layers; across four thread ranks on {MOE_MESH} with "
        f"{MOE_MESH_CFG.experts} experts; the bench's moe mode)")
    moe_record = moe_phase(device, kernels, card)

    log(f"phase pipeline (the bench's pp mode: the dense model, "
        f"{PP_CFG.layers} layers, batch {PP_RUN['batch']}, seq "
        f"{PP_RUN['seq']}, {PP_RUN['micro']} microbatches, f32 then bf16; "
        f"GPipe and 1F1B across four thread ranks on {PP_MESH}; their "
        f"memory at {PP_MEMORY_MICRO} microbatches)")
    pp_record = pp_phase(device, kernels, card)

    log(f"phase serving (the continuous-batching engine on the decode "
        f"model, {SERVE_CFG.layers} layers, d_model {SERVE_CFG.d_model}, "
        f"vocab {SERVE_CFG.vocab}, f32: {SERVE_RUN['requests']} requests on "
        f"one card at max_batch {SERVE_RUN['max_batch']}, max_len "
        f"{SERVE_RUN['max_len']}; an open-loop window; the planted fault; "
        f"a {SERVE_PROC['ranks']}-rank --serve job; the bench's serving "
        f"leg)")
    serve_record = serve_phase(device, kernels, card)

    log(f"phase fault tolerance (the flagship at {cfg.ny}x{cfg.nx}, ghost "
        f"{cfg.ghost}, resumed from a checkpoint; a {RECOVER['ranks']}-rank "
        f"--restarts 1 job; a {ELASTIC_RUN['ranks']}-rank --elastic rejoin "
        f"job of run_elastic at d {ELASTIC_RUN['d']}, {ELASTIC_RUN['layers']} "
        f"layers)")
    elastic_record = elastic_phase(device, kernels, card)

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"path": path, "profile": profile,
                    "schedules": schedules, "multirank": multirank,
                    "bench": bench_record,
                    "decode_path": decode_path,
                    "decode_profile": decode_profile,
                    "short_decode": short_decode,
                    "train_path": train, "train_profile": train_profile,
                    "bench_training": bench_training,
                    "mesh_train": mesh_train, "mesh_decode": mesh_decode,
                    "proc": proc, "mlp_mesh": mlp_mesh, "moe": moe_record,
                    "pp": pp_record, "serve": serve_record,
                    "elastic": elastic_record,
                    "copy_bytes_per_s": copy_rate, "ptxas": ptxas,
                    "nvcc_s": {name: _build.build_seconds(name)
                               for name in SOURCES},
                    "bridge_gxx_s": native_build.build_seconds()}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
