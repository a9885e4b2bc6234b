#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``thunder_tpu_torch`` only (no JAX, nothing of ``thunder_tpu``):

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds the CUDA kernels from ``thunder_tpu_torch/csrc`` for sm_90a and
   prints the build seconds and ptxas' register/spill lines;
3. runs each kernel at the shapes its paths give it: open_llama_3b's loss
   (B=2), forward (B=10) and training step (B=2); the norm executor's
   RMSNorm at open_llama_3b's (4096, 3200) and LayerNorm at pythia-410m's
   (4096, 1024); the training kernels at pythia-410m's shapes; the masked
   forward and recompute backward on the padded path's (2, 32, 2048, 100),
   with a planted fault (the padding ignored) that must fail; the legacy
   route's forward and backward (row 10) at the training path's; the int8
   GEMM (``wgmma``/TMA) at open_llama_3b's five products (M = 4096),
   bit-equal, with a planted fault (the K tail unread) that must differ,
   timed beside the ``mma.sync`` kernel it replaces on that path; the
   quantization kernels at the path's activations (per tensor) and weights
   (per row), bit-equal, with a planted fault (products with the
   reciprocal in place of the divisions) that must differ. Each is
   held against its plain PyTorch version on the same inputs row by row and
   timed on the card beside its plain version and the nearest single
   PyTorch call (CUDA events); the launch plans of rope (at both batches
   and in the backward), of each norm forward and backward are printed with
   the achieved TB/s, the share of the bound and a ``torch.profiler``
   split of the kernel's own device time;
4. checks the whole path at open_llama_3b's full width with 2 layers, forward
   at B=10, loss and gradients (``value_and_grad``) at B=2: the default
   executors against the torch executor alone, then the same with a planted
   attention fault in the forward and one in the backward, which must fail;
5. runs the full 26-layer open_llama_3b: ``jit(loss_fn)`` at B=2, T=2048 and
   ``jit(forward)`` at B=10, T=2048, with random weights from a seed, each
   staged as a CUDA graph (warm-up, capture, replay), and checks that each
   kernel was launched the expected number of times; prints the host µs of
   a cache hit of the staged loss through each lookup (the prologues, the
   O(1) key, ``cache="same input"``) and ``cache_info``'s ``fast_hits``;
6. builds the 26-layer training step (``benchmarks/train.py``) at B=2,
   T=2048 and runs 3 unstaged steps: prints the build seconds of each pass,
   the step seconds, the peak device memory and the loss, checks the
   launches of each kernel against the claimed traces and one param's
   in-place SGD update; then puts the params back and runs 3 staged steps
   (``Train.step``, one CUDA graph) from the same state, launches checked
   per step, losses against the unstaged ones; each step is then timed and
   profiled, and s/step, enqueue ms, busy share and peak memory printed
   side by side;
7. checks pythia-410m at full width with 2 layers, forward and gradients at
   B=2: the norm executor's stack against the torch executor alone, then
   with a planted fault in the LayerNorm forward and one in its backward,
   which must fail;
8. runs the LitGPT benchmark (``benchmarks/litgpt.py``) on the full
   24-layer pythia-410m at B=2, T=2048 with AdamW, under the default stack
   and under ``+norm`` (2 warm-up and 5 timed steps each, staged: the
   warm-up is the eager first call and the capture): prints s/iter,
   tokens/s, MFU, peak memory and the loss, checks the launches of each
   kernel against the claimed trace, and one more step's AdamW update of a
   param against the formula; then the default stack's step unstaged and
   staged from the same state, side by side as in phase 6;
9. runs the LitGPT benchmark on open_llama_3b under ``+norm`` with SGD
   (2 warm-up and 3 timed steps), with the same checks;
10. checks ``thunder_tpu_torch.jit(module)`` on the Llama stand-in below
   (HF ``LlamaForCausalLM``'s names and SDPA-path arithmetic) at
   open_llama_3b's full width with 2 layers, on a batch whose row 0 is
   left-padded by 512 tokens: the default executors against the torch
   executor alone for the valid rows' logits, the loss and every gradient,
   then with the masked kernels ignoring the padding, which must fail; and
   an ALiBi-like bias, which must take the exact branch;
11. runs the stand-in at full depth (26 layers) on that padded batch, its
   forward and backward staged as a CUDA graph each (the mask verdict taken
   when the entry compiles and held by its value guard, one host read a
   call): the forward without grad, the all-ones mask (the value guard's
   second entry), 3 ``torch.optim.SGD`` steps with a falling loss, launches
   checked against the claimed traces; then the staged module against the
   same module jitted with ``disable_jit_staging=True`` from the same state
   (forward logits, a step's loss and grads, ``torch.equal``; enqueue ms and
   a step's peak memory both ways), and one profiled forward and step each
   way: the staged step's peak at most 1 GiB and its mean device time at
   most 1% above the unstaged step's (the forward and backward graphs share
   one memory pool), the device times from 4 steps each way traced on the
   device alone (``kernel_ms``), in turns;
12. runs 3 staged open_llama_3b training steps under
   ``THUNDER_FLASH_IMPL=legacy``: the legacy route's launches (row 10)
   against the claimed traces, the losses against phase 6's splash route;
13. trains open_llama_3b in mixed precision: f32 weights from the seed,
   ``value_and_grad(loss_fn, autocast="bfloat16")`` and the f32 SGD update
   of ``parallel.train.sgd_update``: the 2-layer cut against the torch
   executor (phase 4's limits), then 26 layers, 3 steps unstaged and 3
   staged as one CUDA graph from the same state, launches against the
   trace (rope on f32 rows), losses bit-equal, s/step, enqueue, peak memory
   beside phase 6's bf16 step;
14. checks the keyed draw kernel (``csrc/rng.cu``) against its plain
   version at (2, 2048, 3200) and (4096, 32000), bf16 and f32, bit-equal,
   timed with its bound; then a staged ``jit(F.dropout(x, 0.1))`` on
   (2, 2048, 3200) bf16: a fresh mask each replay, staged equal to
   unstaged after ``seed``, the keep rate within 5 sigma of its expectation;
15. trains open_llama_3b (26 layers, B=2, T=2048) with every linear of
   the forward through the quantization kernels and the int8 GEMM
   (``executors=["quant", "flash", "fused", "torch"]``, straight-through
   bf16 backward, phase 6's SGD): the loss with the kernels bit-equal to
   the loss with their plain versions in their seats, and a planted fault
   (the K tail unread) that must differ; 3 steps unstaged, then 3 staged
   from the same state (losses bit-equal, 131 int8 GEMMs and 131 of each
   quantization a step), device time by kernel group, the first loss
   against phase 6's bf16 step's on the same weights, each later step's
   fall against the bf16 step's, s/step, enqueue and peak memory;
16. serves open_llama_3b's forward (26 layers, B=2) under
   ``cache="symbolic values"`` at T = 2048, 1950, 2000 and 1900: two
   128-wide buckets, one entry and one CUDA graph each, cropped logits
   against the exact-shape jit, s/call and padding waste per T; the loss
   under padding against the exact loss, the CE kernel still claimed; then
   the Llama stand-in at 2 layers under ``jit(module, seq_bucket=128)`` at
   T = 1950 and 2000 with one forward capture;
18. per-sample gradients at open_llama_3b's full width, bf16: (a) 2 layers,
   ``vmap(grad(loss_fn), in_axes=(None, 0, 0))`` over 2 samples of
   (1, 2048), the default stack and ``+norm``, each sample's grads against
   ``grad(loss_fn)`` at B=1 (the jit path, the same kernels) and against
   the vmap under the torch executor alone (phase 4's limit), one launch a
   call site (the B=1 program's launches), and a planted fault in a
   batching rule (flash reading slice 0's k and v for every slice; the
   norm backward's dw folded over the slices) that must fail; (b) 2 layers,
   ``value_and_grad(vmap(loss_fn))`` against the sum of (a)'s per-sample
   grads, and ``jvp`` with the grads as tangents against their squared
   norm, with no kernel launch; (c) 26 layers, ``vmap(grad)`` staged as one
   CUDA graph, its launches a call against the claimed trace and the B=1
   grad program's, s/call, enqueue, peak memory and device ms by group,
   beside ``grad(loss_fn)`` at B=2 on the same tokens;
19. the last batching rules at full width: (a) ``vmap(grad)`` of the
   loss's functional form (``_fn_loss``: the GPT forward with an attention
   mask and the rope tables as inputs) over 2 samples of (1, 2048), sample
   0 left-padded by 512 under a 4-D causal mask: at 2 layers against
   ``grad`` at B=1 (bit-equal counted), rows 8-9 once a call site, a
   planted fault (one mask verdict shared by the slices, one of them under
   a sliding window) that must fail; at 26 layers staged, profiled beside
   ``grad`` at B=2; (b) two open_llama_3b models stacked under ``+norm``,
   each with its own norm weights (1 + 0.1 N(0, 1), from its own seed) and
   rope tables offset by its first position: the per-slice rules bit-equal
   to each model's own calls, with a planted fault (slice 0's weight and
   tables given to every slice) that must fail, one
   RMSNorm and one rope launch a call site, logits against each model
   alone; (c) per-sample grads under the ``quant`` stack: per-slice scales,
   int8 operands and GEMM outputs bit-equal to each slice's own calls, one
   launch of each quantization kernel and of the GEMM a call site;
20. the analysis layer: (a) ``debug_checks=True`` on the staged 26-layer
   step and the B=10 forward (no ERROR, the same results; the verifier's
   seconds a pass) and ``examine.lint`` of the step; (b) the liveness
   plan's predicted peaks against ``max_memory_allocated`` and
   ``mem.predicted-oom`` at B=32 with nothing allocated; (c) ``cost.py``
   against every kernel row's bound, and ``trace_cost`` of the step by kind
   beside its device ms by group;
21. the observability layer at open_llama_3b's full width: (a) the
   26-layer staged loss and training step under ``jit(events=<path>)`` with
   metrics on, the log replayed (no ERROR, the compile brackets paired, a
   ``pass`` event with its ms for every timed pass), ``monitor.report()``'s
   cache hits by kind against ``cache_info``, a fast hit's host µs with
   metrics off and on in turns (medians within 5%); (b) 2 layers:
   ``debug_watch="nan"`` with a planted +inf/-inf stopping at the first op
   with a non-finite output, the unplanted instrumented loss bit-equal to
   the unstaged one on the card, ``instrument="time"``'s flash, rope and CE
   times between 1x and 2x phase 3's rows, ``instrument="memory"``'s peak
   within 2% of ``max_memory_allocated``; (c) the staged ``build_train``
   step built under ``THUNDER_ANNOTATE_TRACES=1``, profiled over 3 steps and
   attributed to trace lines through the launch-order map of its eager
   step: at least 95% attributed, the per-step total within 3% of
   ``profile_call``'s device ms, the flash, rope and CE lines within 1% of
   their groups in the profiled window (printed beside ``profile_call``'s)
   with the wrappers' launch counts, each kernel line's joined
   bound equal to phase 20 (c)'s, the top lines and "other" by line; (d) the
   roofline sampler every 2 steps over 6: 3 probes, a ledger row for every
   kernel line, no recapture, the steps between probes within 1% of
   unsampled steps; (e) ``benchmarks.targets`` rows for ``sdpa`` and the
   Llama block's train unit under ``kernels`` and ``torch``;
22. distribution on ``torch.distributed``, a process group of one NCCL rank
   (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` set here, the
   group torn down after): (a) each collective prim (all_reduce, sum and
   avg, all_gather on dims 0 and 1, reduce_scatter, broadcast, synchronize
   sharded and replicated, an async gather and its wait, ppermute,
   all_to_all, mask_to_rank, hier_all_reduce) staged as a CUDA graph, at
   a (3200, 8640) grad's and the (32000, 3200) embedding's shapes, equal to
   its one-rank value on every call, each prim's count of collective calls
   held to what it issues at one rank, the device work the profiler saw;
   at one rank synchronize (fsdp or replicated), hier_all_reduce,
   ppermute and mask_to_rank call no collective (the identity, a copy, a
   local op), so their graphs hold no NCCL call, and the fsdp gathers of
   (b) run no NCCL call on the card;
   (b) the Llama stand-in at full depth on phase 11's padded batch and
   weights: 3 staged SGD steps untagged, then under ``ddp``, ``fsdp``
   ZERO2 and ZERO3, each step's loss and every grad ``torch.equal`` to the
   untagged step's, the launches a step equal, ``synchronize`` in the
   forward and the grad all-reduce or reduce-scatter (and ZERO3's gather)
   in the backward, ms a step, device ms and peak memory side by side;
   (e) the staged ddp step profiled and attributed through its eager
   step's launch-order map: the collective rows, the compile's
   ``COLLECTIVE_BYTES`` against its traces' collective operands and
   ``cost.py``'s wire bytes; (c) ``no_sync`` at 2 layers, 2 microbatches
   of B=1 against one B=2 step within phase 4's limits, no collective in
   the no-sync backward; (d) the ZERO3 module's state saved through
   ``distributed.checkpoint``, loaded with every leaf on the card, and
   put into a fresh module bit-equal;
23. the mesh and the sharded training step (``parallel/``), a process group
   of one NCCL rank of its own, torn down after: (a) ``build_train_step``
   on ``make_mesh(dp=1, fsdp=1, tp=1)`` with ``gpt_param_specs`` and
   ``shard_pytree`` at open_llama_3b's full size, bf16, B=2 x T=2048,
   3 staged steps with SGD and with AdamW (both donated), each loss and
   every param after step 3 ``torch.equal`` to the unmeshed step's from
   the same weights, the launches of each kernel row a step equal, device
   ms and enqueue ms (``profile_call``) and the peak of steps 2-3 beside
   the unmeshed step's (within 1 GiB), the collectives the step's program
   holds and the NCCL calls it made, by family; (b) the LitGPT CLI through
   ``benchmarks/distributed.run_config("dp1", ...)`` on pythia-410m, rank
   0's JSON line parsed; (c) the fleet timeline (``monitor.critpath``),
   driven by phase 22 (b)'s staged ddp step while its graphs are alive:
   20 steps of wall spans and the collective rows of (e)'s attribution
   folded, the class fractions summing to each step's wall, the exposed
   collective share beside attribution's, ``critpath_report()`` and the
   replay of its event log with no unknown kind;
24. context, pipeline and expert parallelism (``parallel/``), a process
   group of one NCCL rank of its own, torn down after: (a) open_llama_3b at
   full width and 13 layers, bf16, B=4 x T=2048 in 4 microbatches of one row, on
   ``make_mesh(pp=1)`` with the default executors: GPipe and 1F1B through
   ``parallel.gpt_pp.gpt_pp_loss_and_grads``, 3 calls each (eager, capture,
   replay: the whole step one CUDA graph), each call's loss and every grad
   against the unpipelined joint program's on the same batch and weights
   (phase 4's limits), the launches of rows 1-7 against the claimed stage
   programs' sites times their calls (the one stage is the last, which runs
   no stage forward: row 1 does not launch), the peak of calls 2-3 (1F1B's under
   GPipe's), device ms beside the unpipelined program's, ``StagingStats``,
   and a planted fault (microbatch 2's targets rolled by one) that must
   fail; (b) ``parallel.moe.moe_mlp`` at ep=1 and mixtral-8x7b's widths (E=8,
   d=4096, h=14336, 4096 tokens, top-2, f32) against the dense oracle,
   values and router/w1/w2 grads within ``moe_ep``'s tolerances, a control
   with the router softmax and the einsums in bf16 that must fail them; at capacity
   1280 the kept assignments and the fully dropped tokens' zero rows against
   a host replication of the slot accounting, the port's topk on the card
   against the CPU's; a planted fault (the router weights left out of the
   combine); (c) ring and Ulysses attention at sp=1 on (1, 32, 2048, 100)
   bf16 against the flash kernel and its backward (phase 3's limits), a
   planted fault (the ring's 1/l left out), every output on the card; (d)
   ``build_train_step`` on ``make_mesh(pp=1, ep=1, sp=1)`` against the
   unmeshed step at 2 layers, bit for bit;
25. the recovery layer (``thunder_tpu_torch/resilience``), at
   open_llama_3b's full width, bf16, B=2 x T=2048, through
   ``jit(value_and_grad(loss_fn))`` and the port's in-place SGD: (a)
   ``run_training`` for 4 steps, then preempted at step 2 (chaos
   ``preempt@2``) into a ``CheckpointManager`` in a temporary directory and
   resumed by a fresh manager and a fresh jit, the 4 losses and every final
   param ``torch.equal`` to the uninterrupted run's, the checkpoint's bytes,
   save and restore seconds and free disk (the layers cut, width kept, when
   the disk is short); (b) ``snapshot_every=1`` with a ``SnapshotStore`` and
   ``host_loss@3``: ``elastic_resume`` onto the same one-rank mesh wins from
   the RAM tier, the continued step bit-equal, each snapshot's ``stall_ms``
   and copy rate; (c) at 4 layers, a real ``torch.OutOfMemoryError`` under
   ``set_per_process_memory_fraction`` (the cap from ``predict_level_peaks``
   against L0's measured peak) climbs the de-opt ladder, its
   ``compile_deopt`` events printed, the recovered step against the uncapped
   one (or, when no level is predicted to fit, the typed error of the
   exhausted ladder), ``memory_allocated`` after it equal to a fresh
   compile's; (d) at 2 layers, ``kernel_raise`` on the flash wrapper: the
   WARNING and the events, rows 6-7 launched zero times by the demoted entry,
   its loss within phase 4's limit of the undemoted one and equal to the
   fused and torch executors'; after ``clear_quarantine()`` a recompile
   launches them again; (e) ``on_nan=None`` against ``"raise"`` on the staged step, event
   and wall ms over 10 calls in two rounds and the profiler's device ms, and
   at 2 layers a ``nan`` on the ``sdpa_fwd_res`` line named by the
   instrumented re-run; (f) at one NCCL rank, a ``collective_hang`` under a
   2 s watchdog at the two dispatch sites it guards: ``jit``'s staged ddp
   ``value_and_grad`` at 2 layers and a ``shard_map_callable`` all-reduce
   each raise ``CollectiveTimeoutError`` naming their own collective lines,
   the abandoned worker runs no replay once its hang ends, and the next
   unguarded call gives the step with no collectives (the one-rank value);
26. the fleet layer, a process group of one NCCL rank, the ops plane armed
   by ``monitor.serve(port=0)``: (a) open_llama_3b at P26_LAYERS layers
   (width kept), ``build_train_step`` (SGD) under
   ``run_autopiloted_training`` with a 2 s watchdog and a RAM snapshot a
   step: a collective hang at step 2 gives one same-mesh ``elastic_resume``
   decision, the resume from the RAM tier and losses bit-equal to the run
   with no fault; ``preempt@3`` a ``checkpoint_halt`` decision and
   ``AutopilotHalt``, then a fresh manager and step resume from disk to the
   end, bit-equal; ``oom*1`` at the first call of a staged
   ``value_and_grad``: the ``deopt_escalate`` decision before its
   ``compile_deopt``; the event log replays with no unrecovered fault and
   no unactuated decision, ``AUTOPILOT_DECISIONS`` counts each decision;
   (b) ``/healthz`` (degraded after the timeout), ``/metrics``,
   ``/debug/state`` (the de-opted step's ``entry_degradation_levels``) and
   ``/debug/flightrec`` read over HTTP during the run, one schema-valid
   dump each for the timeout and the halt, a staged hit's host µs and the
   step's device ms with the plane armed and off; (c) at P26_FED_LAYERS
   layers, ``run_federated_training`` over 2 slices of one rank under
   ``slice_loss@2,slice=1``: ``shrink_dp`` then ``regrow_dp``, the shrink's
   restore from the buddy's RAM, width 1's two B=1 micro-steps within
   bf16 of the full-width run's B=2 step, and the peer-tier restore
   seconds;
27. the compiled-program audit (``analysis/hlo_audit.py``; there is no HLO:
   the staged CUDA graph and the profiler's op record): (a) open_llama_3b at
   full width, AUDIT_LAYERS layers, bf16, B=2 x T=2048, the staged
   ``value_and_grad``: the ``hlo_audit`` compile phase attached its report
   to the entry; the graph's nodes of kernel rows 1-7 (flash forward with
   lse and backward, rope forward and backward, cross-entropy forward and
   backward) equal to the launches the capture counted; the priced nodes'
   operations within 1% of ``cost.trace_cost``; no host transfer; the
   layout copies, the dump's bytes, parse and audit seconds printed; (b) the
   ddp step of phase 22 (the Llama stand-in, DDP_AUDIT_LAYERS layers, one
   NCCL rank), its forward and backward graphs: a site for each collective
   line of the two traces, all explicit, the nodes NCCL made for them at
   one rank, the exposed share beside the timeline's measured one from
   phase 23 (c); (c) planted faults: an ``.item()`` in a program (which
   keeps it from staging) makes ``hlo.host-transfer-in-step`` fire in the
   audit of its record, a staged program's copy into pinned host memory
   makes it fire in the audit of its graph (whose DOT text is printed: the
   CPU tests' golden excerpt), and ``THUNDER_TPU_HLO_AUDIT=0`` leaves no
   report, no kept graph and no line marks;
28. the runnable tools (``thunder_tpu_torch/examples``,
   ``thunder_tpu_torch/scripts``): (a) ``examples.train.run`` with the
   example's defaults (pythia-160m, full depth, T = 2048, SGD) at B=2,
   staged: the launches of its 6 steps equal the claimed trace's a step
   times 6 (flash forward-with-lse and backward, CE forward and backward;
   rope is not claimed: pythia's rotary covers a quarter of the head), finite
   losses, s/iter and tok/s; (b) ``lint_traces --device cuda``, the default
   corpus, exit 0; (c) ``profile_train`` on open_llama_3b at
   P28_PROFILE_LAYERS layers (B=2 x T=2048, the staged step profiled for 3
   steps with its launch-order map), then ``perf_report``'s attribution with
   the cost join: every step's graph kernels equal to the map, every one
   placed on a line, the flash, CE and rope kernels under the lines that
   claim them, at least ATTRIBUTED_SHARE (95%) of device time attributed,
   a line priced by the join;
29. after phase 28, prints one JSON line describing every kernel, then the
   device line.

Any failed check raises, and the script exits non-zero without printing the
last line. Exits non-zero at once when there is no CUDA card.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import nn

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# 32-bit integer operations a second: 132 SMs x 128 lanes (the integer ALU
# and the FMA pipe, which also issues integer adds) x the 1.98 GHz boost
# clock of the 67 TFLOP/s f32 rate; the most the card issues.
PEAK_INT32_OPS = 132 * 128 * 1.98e9
# threefry-2x32's 32-bit integer operations per element drawn (csrc/rng.cu).
RNG_OPS_PER_ELEMENT = 76

CFG_NAME = "open_llama_3b"
SEQ = 2048
LOSS_BATCH = 2
FWD_BATCH = 10
SEED = 0


_START = time.perf_counter()
# Readings a later phase prints beside its own (phase 27 (b): phase 23 (c)'s).
_NOTES: dict = {}


def log(msg: str) -> None:
    """Print a line; a phase's header (``[N] ...``) ends with the seconds
    since the script started."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - _START:.1f} s)"
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """The card's time for one call of ``fn``: the average over ``iters``
    calls launched back to back, between two CUDA events. A sleep kernel
    holds the card while the host enqueues the calls, so the host's time to
    launch them (Python, a wrapper's checks) does not show, as it would for
    a kernel of a few microseconds; if the card woke before the last call
    was queued, it sleeps twice as long and the calls are timed again."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sleep_s = 2 * (time.perf_counter() - t) + 1e-3
    torch.cuda.synchronize()
    for _ in range(4):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles; the H100's clock is below 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        hidden = not start.query()  # the card was still asleep when the last call was queued
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(stop) / iters
        sleep_s *= 2
    raise SystemExit("FAILED: time_ms could not hide the host's launches behind the card's sleep")


def _library_ms(*calls):
    """The time of the first of ``calls`` that runs: a yardstick only, so a
    library call that refuses these shapes gives None, not a failure."""
    for call in calls:
        try:
            call()
        except RuntimeError:
            continue
        return time_ms(call, 20)
    return None


def _lse_library_calls(q, k, v, scale: float) -> tuple:
    """One PyTorch call each that computes causal attention and saves its
    logsumexp: the aten efficient and flash ops (which refuse some head
    sizes), then SDPA on inputs that require grad (which pads the head and
    saves the logsumexp for its backward)."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    return (
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q, k, v, None, True, 0.0, True, scale=scale),
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False, scale=scale),
        lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale),
    )


def _sdpa_bwd_library_ms(q, k, v, dout, scale: float) -> float:
    """The time of SDPA's autograd backward: (dq, dk, dv) of causal attention
    from its saved forward."""
    import torch
    import torch.nn.functional as F

    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, scale=scale)
    return time_ms(lambda: torch.autograd.grad(ref, (qr, kr, vr), dout, retain_graph=True), 10)


def kernel_split_us(fn, calls: int = 20) -> dict:
    """Device microseconds a call of ``fn`` spends in each CUDA kernel, from
    ``torch.profiler`` over ``calls`` calls; empty when the profiler sees no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls for e in prof.key_averages()
            if e.device_time_total > 0 and e.count >= calls}


def log_plan_and_split(tag: str, plan, nbytes: float, ms: float, bound_ms: float, fn, kernel: str) -> None:
    """Log a kernel's launch plan, its rate against the card's and its share
    of the bound, then its own device time from ``kernel_split_us`` (the
    kernels whose name holds ``kernel``)."""
    log(f"  {tag} plan: {plan}; {nbytes / ms / 1e9:.3f} TB/s against {PEAK_BYTES / 1e12:.2f} TB/s "
        f"({bound_ms / ms:.1%} of the bound)")
    split = {k: v for k, v in kernel_split_us(fn).items() if kernel in k}
    log(f"  {tag} profiler: " + ("not measured (no device time)" if not split else "; ".join(
        f"{re.search(kernel + r'[a-z_]*', k).group(0)} {v:.2f} us, {nbytes / v / 1e6:.3f} TB/s"
        for k, v in split.items())))


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# =============================================================================
# The Llama stand-in: the module that phases 10-11 jit
# =============================================================================
#
# The machine with the card has no ``transformers``, so the nn.Module path
# runs on this plain-torch Llama. Its module and parameter names are those of
# HF's ``LlamaForCausalLM``, and it follows the arithmetic of transformers
# 4.57's SDPA path: rotate-half rope from ``inv_freq`` in f32, cast to the
# model's dtype; RMSNorm in f32, cast back, then scaled by the weight;
# SwiGLU; ``repeat_kv`` before SDPA when there is a mask, GQA in SDPA when
# there is none; and HF's mask: none (and ``is_causal``) when
# ``attention_mask.all()`` holds, else a bool (B, 1, T, T) causal∧padding
# mask. The CPU tests hold it against ``transformers.LlamaForCausalLM`` with
# the same state_dict. It is the smoke test's model, not a package feature.


@dataclass(frozen=True)
class LlamaConfig:
    """The fields of HF's LlamaConfig that the stand-in reads."""

    vocab_size: int = 32000
    hidden_size: int = 3200
    intermediate_size: int = 8640
    num_hidden_layers: int = 26
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# open_llama_3b (the JAX package's config, thunder_tpu/models/gpt.py:116-119)
OPEN_LLAMA_3B = LlamaConfig()


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, **factory))
        self.variance_epsilon = eps

    def forward(self, hidden_states):
        input_dtype = hidden_states.dtype
        hidden_states = hidden_states.to(torch.float32)
        variance = hidden_states.pow(2).mean(-1, keepdim=True)
        hidden_states = hidden_states * torch.rsqrt(variance + self.variance_epsilon)
        return self.weight * hidden_states.to(input_dtype)


class LlamaRotaryEmbedding(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dim = config.head_dim
        inv_freq = 1.0 / (config.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=device).float() / dim))
        self.register_buffer("inv_freq", inv_freq, persistent=False)

    def forward(self, x, position_ids):
        inv_freq_expanded = self.inv_freq[None, :, None].float().expand(position_ids.shape[0], -1, 1)
        position_ids_expanded = position_ids[:, None, :].float()
        freqs = (inv_freq_expanded.float() @ position_ids_expanded.float()).transpose(1, 2)
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos().to(dtype=x.dtype), emb.sin().to(dtype=x.dtype)


def _rotate_half(x):
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _repeat_kv(hidden_states, n_rep: int):
    batch, num_key_value_heads, slen, head_dim = hidden_states.shape
    if n_rep == 1:
        return hidden_states
    hidden_states = hidden_states[:, :, None, :, :].expand(batch, num_key_value_heads, n_rep, slen, head_dim)
    return hidden_states.reshape(batch, num_key_value_heads * n_rep, slen, head_dim)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        hd, H, G = config.head_dim, config.num_attention_heads, config.num_key_value_heads
        self.head_dim = hd
        self.num_key_value_groups = H // G
        self.scaling = hd ** -0.5
        self.q_proj = nn.Linear(config.hidden_size, H * hd, bias=False, **factory)
        self.k_proj = nn.Linear(config.hidden_size, G * hd, bias=False, **factory)
        self.v_proj = nn.Linear(config.hidden_size, G * hd, bias=False, **factory)
        self.o_proj = nn.Linear(H * hd, config.hidden_size, bias=False, **factory)

    def forward(self, hidden_states, position_embeddings, attention_mask):
        input_shape = hidden_states.shape[:-1]
        hidden_shape = (*input_shape, -1, self.head_dim)
        query = self.q_proj(hidden_states).view(hidden_shape).transpose(1, 2)
        key = self.k_proj(hidden_states).view(hidden_shape).transpose(1, 2)
        value = self.v_proj(hidden_states).view(hidden_shape).transpose(1, 2)
        cos, sin = position_embeddings
        cos, sin = cos.unsqueeze(1), sin.unsqueeze(1)
        query = (query * cos) + (_rotate_half(query) * sin)
        key = (key * cos) + (_rotate_half(key) * sin)
        # transformers' sdpa_attention_forward: GQA inside SDPA without a
        # mask, repeat_kv with one; is_causal only without a mask.
        sdpa_kwargs = {}
        if attention_mask is None:
            sdpa_kwargs = {"enable_gqa": True}
        else:
            key = _repeat_kv(key, self.num_key_value_groups)
            value = _repeat_kv(value, self.num_key_value_groups)
            attention_mask = attention_mask[:, :, :, : key.shape[-2]]
        is_causal = query.shape[2] > 1 and attention_mask is None
        out = torch.nn.functional.scaled_dot_product_attention(
            query, key, value, attn_mask=attention_mask, dropout_p=0.0, scale=self.scaling, is_causal=is_causal,
            **sdpa_kwargs)
        out = out.transpose(1, 2).contiguous()
        out = out.reshape(*input_shape, -1).contiguous()
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.gate_proj = nn.Linear(config.hidden_size, config.intermediate_size, bias=False, **factory)
        self.up_proj = nn.Linear(config.hidden_size, config.intermediate_size, bias=False, **factory)
        self.down_proj = nn.Linear(config.intermediate_size, config.hidden_size, bias=False, **factory)

    def forward(self, x):
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(config, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **factory)

    def forward(self, hidden_states, attention_mask, position_embeddings):
        residual = hidden_states
        hidden_states = self.self_attn(self.input_layernorm(hidden_states), position_embeddings, attention_mask)
        hidden_states = residual + hidden_states
        residual = hidden_states
        return residual + self.mlp(self.post_attention_layernorm(hidden_states))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, **factory)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **factory) for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **factory)
        self.rotary_emb = LlamaRotaryEmbedding(config, device=factory.get("device"))

    @staticmethod
    def causal_mask(attention_mask, T: int):
        """HF's SDPA mask: None when every token is valid (the caller then
        runs causal SDPA), else a bool (B, 1, T, T) mask, query i seeing key
        j iff j <= i and key j is valid. ``attention_mask.all()`` is a
        branch on data: under the jit it becomes a value guard."""
        if attention_mask is None or attention_mask.all():
            return None
        idx = torch.arange(T, device=attention_mask.device)
        causal = idx[None, :] <= idx[:, None]
        return causal[None, None, :, :] & attention_mask.bool()[:, None, None, :]

    def forward(self, input_ids, attention_mask=None):
        hidden_states = self.embed_tokens(input_ids)
        T = input_ids.shape[1]
        position_ids = torch.arange(T, device=input_ids.device).unsqueeze(0)
        mask = self.causal_mask(attention_mask, T)
        position_embeddings = self.rotary_emb(hidden_states, position_ids)
        for layer in self.layers:
            hidden_states = layer(hidden_states, mask, position_embeddings)
        return self.norm(hidden_states)


class LlamaForCausalLM(nn.Module):
    """HF's module tree and forward: ``{"logits"}``, and ``{"loss"}`` when
    ``labels`` are given: cross-entropy of the f32 logits against labels
    already aligned with them (the next token; −100 where nothing is to be
    predicted, e.g. at pads), mean over the labelled positions."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        factory = {"device": device, "dtype": dtype}
        self.config = config
        self.model = LlamaModel(config, **factory)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False, **factory)

    def forward(self, input_ids, attention_mask=None, labels=None):
        logits = self.lm_head(self.model(input_ids, attention_mask))
        out = {"logits": logits}
        if labels is not None:
            V = logits.shape[-1]
            out["loss"] = torch.nn.functional.cross_entropy(logits.float().reshape(-1, V), labels.reshape(-1),
                                                            ignore_index=-100)
        return out


def llama(config: LlamaConfig, *, seed: int, device, dtype=torch.bfloat16) -> LlamaForCausalLM:
    """The stand-in with random weights from ``seed``: matrices and the
    embedding N(0, 0.02) (HF's initializer_range), norm weights 1, drawn on
    ``device`` in f32 and rounded to ``dtype``."""
    with torch.no_grad():
        m = LlamaForCausalLM(config, device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        for name, p in m.named_parameters():
            if not name.endswith("layernorm.weight") and name != "model.norm.weight":
                p.copy_(torch.empty(p.shape, device=device).normal_(0.0, 0.02, generator=gen))
    return m


def padded_batch(B: int, T: int, vocab: int, left_pad: dict, *, seed: int, device):
    """(input_ids, attention_mask, labels): token ids from ``seed``; batch row
    b left-padded by ``left_pad.get(b, 0)`` tokens (mask 0, id 0); labels the
    next token, −100 at the last position and wherever the query or the next
    token is a pad, so pad rows carry no weight."""
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, vocab, (B, T))).to(device)
    am = torch.ones((B, T), dtype=torch.int64, device=device)
    for b, n in left_pad.items():
        am[b, :n] = 0
        ids[b, :n] = 0
    labels = torch.full((B, T), -100, dtype=torch.int64, device=device)
    labels[:, :-1] = ids[:, 1:]
    labels[:, :-1][(am[:, :-1] == 0) | (am[:, 1:] == 0)] = -100
    return ids, am, labels


# =============================================================================
# Phase 3: each kernel against its plain version at the path shapes
# =============================================================================


def row_rel_err(got, want, floor: float = 0.0) -> float:
    """The largest error in a row over that row's largest |value|, maximised
    over rows (a row is the last dim). A row that is wrong in part shows up
    in full, however small its values are next to other rows'. ``floor``
    (a fraction of the tensor's largest |value|) is the least reference a
    row gets."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1).clamp_min(max(floor * want.abs().max().item(), torch.finfo(torch.float32).tiny))
    return (err / ref).max().item()


# Rope: f32 arithmetic rounded once to bf16 in both kernel and plain version;
# a fused multiply-add may move the rounding by one bf16 ulp of the element,
# which is at most 2^-7 of the row's largest |value|.
ROPE_ROW_REL = 2.0 ** -7
# Flash: both round O to bf16 once (up to one ulp, <= 2^-7 of the row max),
# and round P to bf16 against different maxima (the running max in the
# kernel, the row max in the plain version: relative 2^-9 per term of the
# weighted mean). Two ulps of the row max bound both together.
FLASH_ROW_REL = 2.0 ** -6
# Flash backward: P and dS are rounded to bf16 at the same places in kernel
# and plain version, from f32 values that differ in the last bits (exp2 of
# log2-scaled scores against exp), so a few terms round one ulp apart; with
# the outputs' own rounding, four ulps of the row max bound the difference.
# A row whose exact gradient is zero (query 0 sees only key 0, where dS
# cancels) holds only f32 noise, so each row's reference is at least eps^2 of
# the tensor's largest |value|.
FLASH_BWD_ROW_REL = 2.0 ** -5
# lse: an f32 logsumexp of up to 2048 terms, in base 2 in the kernel.
LSE_REL = 1e-5
# Cross-entropy backward: both compute (softmax - onehot) * scale in f32 and
# differ in summation order and exp's last bits: 1e-5 of the row's largest
# |value| (the target's entry).
CE_BWD_ROW_REL = 1e-5


def _path_inputs(cfg, batch: int, gen):
    """q/k/v as the path gives them to rope (views of the fused qkv
    projection) and rope's bf16 cos/sin tables."""
    import torch

    dev = torch.device("cuda")
    T, H, G, D = SEQ, cfg.n_head, cfg.query_groups, cfg.head_size
    qkv = torch.randn((batch, T, (H + 2 * G) * D), generator=gen, device=dev).to(torch.bfloat16)

    def heads(lo, n):
        return qkv[..., lo * D:(lo + n) * D].reshape(batch, T, n, D).permute(0, 2, 1, 3)

    pos = torch.arange(T, device=dev, dtype=torch.float32)[:, None]
    theta = cfg.rope_base ** (torch.arange(D // 2, device=dev, dtype=torch.float32) * -2.0 / D)
    emb = torch.cat([pos * theta, pos * theta], dim=1)
    return heads(0, H), heads(H, G), heads(H + G, G), emb.cos().to(torch.bfloat16), emb.sin().to(torch.bfloat16)


def _recorder(rows: dict):
    """``record(name, batch, err, rel, limit, **timing)``: log one check of a
    kernel and fold it into its row: the largest errors over every check,
    and the timing of the check at the loss path's batch (or, for a kernel
    first checked here, of its first check)."""

    def record(name, batch, err, rel, limit, **timing):
        new = name not in rows
        row = rows.setdefault(name, dict(name=name, route="cuda", max_abs_err=0.0, row_rel_err=0.0,
                                         row_rel_limit=limit))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["row_rel_err"] = max(row["row_rel_err"], rel)
        t = timing
        log(f"  {name:8s} {str(batch):>6s} max_abs_err={err:.3e} row_rel_err={rel:.3e} (limit {limit:.3e}) "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
        require(rel <= limit, f"{name} kernel disagrees with its plain version at {batch} ({rel} > {limit})")
        if batch == LOSS_BATCH or new:
            row.update(timing)

    return record


def check_kernels(cfg, rows: dict) -> None:
    """Rope and flash at both path batches (loss B=2, forward B=10), CE at the
    loss path's (B*T, V), and the training step's kernels (flash forward with
    logsumexp, flash backward, rope with -sin, CE backward) at B=2. Each is
    held against its plain version on the same inputs and timed; the
    returned rows are the B=2 timings with the largest error over both
    batches."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = _recorder(rows)

    for B in (LOSS_BATCH, FWD_BATCH):
        q_view, k_view, v_view, cos, sin = _path_inputs(cfg, B, gen)

        # -- rope: x (B, H, T, D) bf16, a strided view of qkv ------------------
        got = fusedex.apply_rope(q_view, cos, sin)
        want = fusedex.rope_plain(q_view, cos, sin)
        err = (got.float() - want.float()).abs().max().item()
        nb = q_view.numel() * 2 * 2 + cos.numel() * 2 * 2
        b_ms, b_by = bound(nb, 3.0 * q_view.numel(), PEAK_F32_FLOPS)
        rope = lambda: fusedex.apply_rope(q_view, cos, sin)  # noqa: E731
        ms = time_ms(rope, 50)
        record("rope", B, err, row_rel_err(got, want), ROPE_ROW_REL,
               source="thunder_tpu_torch/csrc/rope.cu", replaces="thunder_tpu/executors/pallasex.py:220",
               ms=ms, plain_ms=time_ms(lambda: fusedex.rope_plain(q_view, cos, sin), 20),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log_plan_and_split(f"rope B={B}", fusedex.rope_plan_of(q_view, cos, sin, got), nb, ms, b_ms, rope,
                           "rope_kernel")
        if B == LOSS_BATCH:  # a table a batch row, as a vmapped table gives it
            cos_s, sin_s = torch.stack([cos, cos.roll(1, 0)]), torch.stack([sin, sin.roll(1, 0)])
            seg = fusedex.apply_rope(q_view, cos_s, sin_s)
            same = all(torch.equal(seg[i:i + 1], fusedex.apply_rope(q_view[i:i + 1], cos_s[i], sin_s[i]))
                       for i in range(B))
            seg_ms = time_ms(lambda: fusedex.apply_rope(q_view, cos_s, sin_s), 50)
            log(f"  rope B={B} with a table a row: {seg_ms:.4f} ms against {ms:.4f} shared "
                f"({seg_ms / ms - 1:+.2%}); each row bit-equal to its own call {same}")
            require(same, "rope with a table a row differs from each row's own call")
            del seg
        del got, want

        # -- flash: q, k rope outputs (contiguous), v a strided view -------------
        q = fusedex.apply_rope(q_view, cos, sin)
        k = fusedex.apply_rope(k_view, cos, sin)
        v = v_view
        scale = 1.0 / math.sqrt(cfg.head_size)
        got = flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale)
        want = flashex.flash_attention_plain(q, k, v, causal=True, scale=scale)
        require(bool(torch.isfinite(got).all()), f"flash kernel produced non-finite values at B={B}")
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        del want
        pairs = SEQ * (SEQ + 1) // 2  # causal (query, key) pairs with Tq == Tkv
        flops = 4.0 * B * cfg.n_head * cfg.head_size * pairs
        nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
        b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS)
        record("flash_fwd", B, err, rel, FLASH_ROW_REL,
               source="thunder_tpu_torch/csrc/flash_attn.cu", replaces="thunder_tpu/executors/flashex.py:243",
               ms=time_ms(lambda: flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale), 20),
               plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=True, scale=scale), 3, 1),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
        del got, q, k, v, q_view, k_view, v_view
        torch.cuda.empty_cache()

    # -- cross-entropy: logits (B*T, V) f32, int64 targets, some ignored -------
    N, V = LOSS_BATCH * SEQ, cfg.padded_vocab_size
    logits = torch.randn((N, V), generator=gen, device="cuda")
    targets = torch.randint(0, V, (N,), generator=gen, device="cuda")
    targets[::97] = -100
    got = fusedex.cross_entropy_rows(logits, targets, -100)
    want = fusedex.cross_entropy_rows_plain(logits, targets, -100)
    err = (got - want).abs().max().item()
    # Per-row losses near 10.9: an f32 logsumexp of 32000 terms summed in
    # another order differs by a few f32 ulps of the loss; 1e-5 relative.
    nb = logits.numel() * 4 + targets.numel() * 8 + N * 4
    b_ms, b_by = bound(nb, 4.0 * N * V, PEAK_F32_FLOPS)
    record("ce_fwd", LOSS_BATCH, err, row_rel_err(got[:, None], want[:, None]), 1e-5,
           source="thunder_tpu_torch/csrc/cross_entropy.cu", replaces="thunder_tpu/executors/pallasex.py:85",
           ms=time_ms(lambda: fusedex.cross_entropy_rows(logits, targets, -100), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_rows_plain(logits, targets, -100), 10),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: F.cross_entropy(logits, targets, ignore_index=-100, reduction="none"), 20))
    del got, want

    # -- the training step's kernels, at B=2 -----------------------------------
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    q_view, k_view, v, cos, sin = _path_inputs(cfg, B, gen)
    q, k = fusedex.apply_rope(q_view, cos, sin), fusedex.apply_rope(k_view, cos, sin)
    del q_view, k_view
    pairs = SEQ * (SEQ + 1) // 2

    # flash forward with logsumexp (A): q, k contiguous, v a strided view.
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale)
    lse_rel = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
    require(lse_rel <= LSE_REL, f"flash_fwd_lse: lse differs from the plain version ({lse_rel} > {LSE_REL})")
    log(f"  flash_fwd_lse lse rel_err={lse_rel:.3e} (limit {LSE_REL:.0e})")
    nb = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, 4.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("flash_fwd_lse", B, (out.float() - want_out.float()).abs().max().item(), row_rel_err(out, want_out),
           FLASH_ROW_REL, source="thunder_tpu_torch/csrc/flash_attn.cu",
           replaces="thunder_tpu/executors/flashex.py:526",
           ms=time_ms(lambda: flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale), 20),
           plain_ms=time_ms(lambda: flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=_library_ms(*_lse_library_calls(q, k, v, scale)))
    del want_out, want_lse

    # flash backward (B): dout strided as the backward of the head transpose
    # gives it; (out, lse) from the kernel.
    dout = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    got = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True, scale=scale)
    require(all(bool(torch.isfinite(g).all()) for g in got), "flash_bwd produced non-finite values")
    eps = 2.0 ** -7
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    rel = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, want))
    del want
    flops = 10.0 * B * H * D * pairs
    # Read q, k, v, out, dout and lse once; write dq, dk, dv once.
    nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + dout.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS)
    record("flash_bwd", B, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
           replaces="thunder_tpu/executors/flashex.py:555",
           ms=time_ms(lambda: flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True,
                                                                      scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=_sdpa_bwd_library_ms(q, k, v, dout, scale))
    dq = got[0]
    del got, out, lse, dout, v

    # rope backward (D): the rope kernel on dq (contiguous) with -sin.
    msin = -sin
    got = fusedex.apply_rope(dq, cos, msin)
    want = fusedex.rope_plain(dq, cos, msin)
    nb = dq.numel() * 2 * 2 + cos.numel() * 2 * 2
    b_ms, b_by = bound(nb, 3.0 * dq.numel(), PEAK_F32_FLOPS)
    rope = lambda: fusedex.apply_rope(dq, cos, msin)  # noqa: E731
    ms = time_ms(rope, 50)
    record("rope_bwd", B, (got.float() - want.float()).abs().max().item(), row_rel_err(got, want), ROPE_ROW_REL,
           source="thunder_tpu_torch/csrc/rope.cu", replaces="thunder_tpu/torch/__init__.py:1579",
           ms=ms, plain_ms=time_ms(lambda: fusedex.rope_plain(dq, cos, msin), 20),
           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log_plan_and_split("rope_bwd", fusedex.rope_plan_of(dq, cos, msin, got), nb, ms, b_ms, rope, "rope_kernel")
    del got, want, dq, q, k
    torch.cuda.empty_cache()

    # cross-entropy backward (C): the loss path's logits, g = 1, mean.
    g = torch.ones((), device="cuda")
    row_scale = fusedex.ce_row_scale(g, targets, -100, "mean")
    got = fusedex.cross_entropy_bwd(logits, targets, row_scale)
    want = fusedex.cross_entropy_bwd_plain(logits, targets, row_scale)
    require(bool((got[::97] == 0).all()), "ce_bwd: an ignored row is not zero")
    nb = logits.numel() * 4 * 2 + targets.numel() * 8 + N * 4
    b_ms, b_by = bound(nb, 5.0 * N * V, PEAK_F32_FLOPS)
    lr_ = logits.detach().clone().requires_grad_()
    ref = F.cross_entropy(lr_, targets, ignore_index=-100)
    record("ce_bwd", B, (got - want).abs().max().item(), row_rel_err(got, want), CE_BWD_ROW_REL,
           source="thunder_tpu_torch/csrc/cross_entropy.cu", replaces="thunder_tpu/executors/pallasex.py:102",
           ms=time_ms(lambda: fusedex.cross_entropy_bwd(logits, targets, row_scale), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_bwd_plain(logits, targets, row_scale), 10),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: torch.autograd.grad(ref, lr_, retain_graph=True), 20))
    del got, want, ref, lr_, logits
    torch.cuda.empty_cache()


# The norm kernels and their plain versions compute in f32 and round each
# output once: y and dx within one bf16 ulp (2^-7) of the row's largest
# |value|; dw and db are f32 sums over the rows in another order, 1e-5 of
# the vector's largest |value|. Set from bf16 rounding, before any reading.
NORM_ROW_REL = 2.0 ** -7
NORM_DW_REL = 1e-5


def check_norm_kernels(llama, pythia, rows: dict) -> None:
    """The norm executor's four kernels at their path shapes: RMSNorm on
    open_llama_3b's (B*T, 3200) bf16 rows with eps 1e-6, LayerNorm with
    bias on pythia-410m's (B*T, 1024) with eps 1e-5. Each is held against
    its plain version and timed beside ``F.rms_norm``/``F.layer_norm`` and
    their autograd backward."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import _build, normex

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = _recorder(rows)
    N = LOSS_BATCH * SEQ
    for cfg, layer_norm in ((llama, False), (pythia, True)):
        D, eps = cfg.n_embd, cfg.norm_eps
        # A residual stream with a per-row offset and a weight and bias away
        # from their init, so that every term of the kernels shows.
        x = (torch.randn((N, D), generator=gen, device="cuda") * 2
             + torch.randn((N, 1), generator=gen, device="cuda")).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.1 * torch.randn((D,), generator=gen, device="cuda")).to(torch.bfloat16) if layer_norm else None
        g = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
        tag, shape = ("ln", f"{N}x{D}") if layer_norm else ("rms", f"{N}x{D}")
        src, repl = "thunder_tpu_torch/csrc/norm.cu", "thunder_tpu/executors/pallasex.py"
        nb = N * D * 2

        if layer_norm:
            fwd = lambda: normex.layer_norm_fwd(x, w, b, eps)  # noqa: E731
            bwd = lambda: normex.layer_norm_bwd(g, x, w, eps, with_bias=True)  # noqa: E731
            lib_fwd = lambda: F.layer_norm(x, (D,), w, b, eps)  # noqa: E731
            params = (w, b)
        else:
            fwd = lambda: normex.rms_norm_fwd(x, w, eps)  # noqa: E731
            bwd = lambda: normex.rms_norm_bwd(g, x, w, eps) + (None,)  # noqa: E731
            lib_fwd = lambda: F.rms_norm(x, (D,), w, eps)  # noqa: E731
            params = (w,)
        plain_fwd = lambda: normex.norm_fwd_plain(x, w, b, eps, layer_norm=layer_norm)  # noqa: E731
        plain_bwd = lambda: normex.norm_bwd_plain(g, x, w, eps, layer_norm=layer_norm,  # noqa: E731
                                                  with_bias=layer_norm)

        got, want = fwd(), plain_fwd()
        fwd_bytes = 2 * nb + len(params) * D * 2
        b_ms, b_by = bound(fwd_bytes, 6.0 * N * D, PEAK_F32_FLOPS)
        ms = time_ms(fwd, 50)
        record(f"{tag}_fwd", shape, (got.float() - want.float()).abs().max().item(), row_rel_err(got, want),
               NORM_ROW_REL, source=src, replaces=f"{repl}:{410 if layer_norm else 299}",
               ms=ms, plain_ms=time_ms(plain_fwd, 10), bound_ms=b_ms, bound_by=b_by,
               library_ms=_library_ms(lib_fwd))
        log_plan_and_split(f"{tag}_fwd", normex.fwd_plan_of(x, w, b, got, layer_norm), fwd_bytes, ms, b_ms, fwd,
                           "norm_fwd_kernel")
        del got, want

        (dx, dw, db), (want_dx, want_dw, want_db) = bwd(), plain_bwd()
        require(bool(torch.isfinite(dx).all()), f"{tag}_bwd produced non-finite values")
        vec_rel = max(((a - r).abs().max() / r.abs().max()).item()
                      for a, r in ((dw, want_dw), (db, want_db)) if r is not None)
        log(f"  {tag}_bwd dw{'/db' if layer_norm else ''} rel_err={vec_rel:.3e} (limit {NORM_DW_REL:.0e})")
        require(vec_rel <= NORM_DW_REL, f"{tag}_bwd: dw/db differ from the plain version ({vec_rel})")
        # Read g, x and w; write dx and the f32 dw (and db).
        bwd_bytes = 3 * nb + D * 2 + len(params) * D * 4
        b_ms, b_by = bound(bwd_bytes, 12.0 * N * D, PEAK_F32_FLOPS)
        xr = x.detach().clone().requires_grad_()
        pr = [p.detach().clone().requires_grad_() for p in params]
        ref = F.layer_norm(xr, (D,), pr[0], pr[1], eps) if layer_norm else F.rms_norm(xr, (D,), pr[0], eps)
        ms = time_ms(bwd, 50)
        plan = normex.bwd_plan(N, D, x.element_size(), layer_norm, _build.sm_count(0), normex._align(D, g, x, w))
        log(f"  {tag}_bwd plan: {plan.mode}, {plan.ctas} CTAs, {plan.groups} row groups of {plan.warps_per_row} "
            f"warp(s), ring depth {plan.depth}, sums in {'registers' if plan.registers else 'device memory'}, "
            f"{plan.smem} B shared; {bwd_bytes / ms / 1e9:.3f} TB/s "
            f"against {PEAK_BYTES / 1e12:.2f} TB/s ({b_ms / ms:.1%} of the bound)")
        # The row kernel's own device time (the column sums are scheduled
        # while it drains, so theirs overlaps it).
        split = kernel_split_us(bwd)
        rows_us = next((v for k, v in split.items() if "norm_bwd_kernel" in k), None)
        log(f"  {tag}_bwd profiler: " + ("not measured (no device time)" if rows_us is None else
            "; ".join(f"{re.search(r'norm_[a-z_]+', k).group(0)} {v:.2f} us" for k, v in split.items() if "norm_" in k)
            + f"; row kernel {bwd_bytes / rows_us / 1e6:.3f} TB/s"))
        record(f"{tag}_bwd", shape, (dx.float() - want_dx.float()).abs().max().item(), row_rel_err(dx, want_dx),
               NORM_ROW_REL, source=src, replaces=f"{repl}:{424 if layer_norm else 309}",
               ms=ms, plain_ms=time_ms(plain_bwd, 10), bound_ms=b_ms, bound_by=b_by,
               library_ms=_library_ms(lambda: torch.autograd.grad(ref, [xr, *pr], g, retain_graph=True)))
        _time_norm_segments(tag, x, g, w, b, eps, layer_norm, fwd, bwd)
        del dx, dw, db, want_dx, want_dw, want_db, ref, xr, pr, x, g
        torch.cuda.empty_cache()


def _time_norm_segments(tag, x, g, w, b, eps, layer_norm, fwd, bwd, V: int = 2) -> None:
    """The norm kernels with a weight (and bias) a segment of the rows, as
    a vmapped weight gives them (V segments): each segment's y and dx
    bit-equal to the shared-weight call on its rows with its weight, and
    their times beside the shared-weight times."""
    import torch

    from thunder_tpu_torch.executors import normex

    ws = torch.stack([w] + [w.roll(i, 0) for i in range(1, V)])
    bs = None if b is None else torch.stack([b] + [b.roll(i, 0) for i in range(1, V)])
    n = x.shape[0] // V
    if layer_norm:
        sfwd = lambda: normex.layer_norm_fwd(x, ws, bs, eps)  # noqa: E731
        sbwd = lambda: normex.layer_norm_bwd(g, x, ws, eps, with_bias=True, segments=V)  # noqa: E731
        alone = lambda i: (normex.layer_norm_fwd(x[i * n:(i + 1) * n], ws[i], bs[i], eps),  # noqa: E731
                           normex.layer_norm_bwd(g[i * n:(i + 1) * n], x[i * n:(i + 1) * n], ws[i], eps,
                                                 with_bias=True)[0])
    else:
        sfwd = lambda: normex.rms_norm_fwd(x, ws, eps)  # noqa: E731
        sbwd = lambda: normex.rms_norm_bwd(g, x, ws, eps, V)  # noqa: E731
        alone = lambda i: (normex.rms_norm_fwd(x[i * n:(i + 1) * n], ws[i], eps),  # noqa: E731
                           normex.rms_norm_bwd(g[i * n:(i + 1) * n], x[i * n:(i + 1) * n], ws[i], eps)[0])
    y, dx = sfwd(), sbwd()[0]
    same = all(torch.equal(y[i * n:(i + 1) * n], a) and torch.equal(dx[i * n:(i + 1) * n], d)
               for i, (a, d) in ((i, alone(i)) for i in range(V)))
    times = {k: (time_ms(f, 50), time_ms(sf, 50)) for k, f, sf in (("fwd", fwd, sfwd), ("bwd", bwd, sbwd))}
    log(f"  {tag} with a weight{' and bias' if layer_norm else ''} a segment (V={V}): " + "; ".join(
        f"{k} {t[1]:.4f} ms against {t[0]:.4f} shared ({t[1] / t[0] - 1:+.2%})" for k, t in times.items())
        + f"; each segment's y and dx bit-equal to its own call {same}")
    require(same, f"{tag} with a weight a segment differs from each segment's own call")


def check_pythia_shapes(cfg, rows: dict) -> None:
    """The training step's attention and cross-entropy kernels at
    pythia-410m's shapes (B=2): q/k/v (2, 16, 2048, 64), where q and k come
    contiguous from the decomposed partial rope and v is a strided view of
    the qkv projection, and logits (4096, 50304) f32. Held to the same
    limits as at open_llama_3b's shapes; the errors join the rows, the
    times are logged."""
    import torch

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    record = _recorder(rows)
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    pairs = SEQ * (SEQ + 1) // 2
    q_view, k_view, v, _, _ = _path_inputs(cfg, B, gen)
    q, k = q_view.contiguous(), k_view.contiguous()
    del q_view, k_view
    shape = f"{B}x{H}x{SEQ}x{D}"

    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale)
    lse_rel = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
    require(lse_rel <= LSE_REL, f"flash_fwd_lse at {shape}: lse differs from the plain version ({lse_rel})")
    nb = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, 4.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("flash_fwd_lse", shape, (out.float() - want_out.float()).abs().max().item(),
           row_rel_err(out, want_out), FLASH_ROW_REL,
           ms=time_ms(lambda: flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale), 20),
           plain_ms=time_ms(lambda: flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=_library_ms(*_lse_library_calls(q, k, v, scale)))
    del want_out, want_lse

    dout = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    got = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True, scale=scale)
    eps = 2.0 ** -7
    nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + dout.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, 10.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("flash_bwd", shape, max((a.float() - r.float()).abs().max().item() for a, r in zip(got, want)),
           max(row_rel_err(a, r, floor=eps * eps) for a, r in zip(got, want)), FLASH_BWD_ROW_REL,
           ms=time_ms(lambda: flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True,
                                                                      scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=_sdpa_bwd_library_ms(q, k, v, dout, scale))
    del got, want, q, k, v, out, lse, dout
    torch.cuda.empty_cache()

    N, V = B * SEQ, cfg.padded_vocab_size
    logits = torch.randn((N, V), generator=gen, device="cuda")
    targets = torch.randint(0, cfg.vocab_size, (N,), generator=gen, device="cuda")
    targets[::97] = -100
    shape = f"{N}x{V}"
    got = fusedex.cross_entropy_rows(logits, targets, -100)
    want = fusedex.cross_entropy_rows_plain(logits, targets, -100)
    b_ms, b_by = bound(logits.numel() * 4 + targets.numel() * 8 + N * 4, 4.0 * N * V, PEAK_F32_FLOPS)
    record("ce_fwd", shape, (got - want).abs().max().item(), row_rel_err(got[:, None], want[:, None]), 1e-5,
           ms=time_ms(lambda: fusedex.cross_entropy_rows(logits, targets, -100), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_rows_plain(logits, targets, -100), 10),
           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    row_scale = fusedex.ce_row_scale(torch.ones((), device="cuda"), targets, -100, "mean")
    got = fusedex.cross_entropy_bwd(logits, targets, row_scale)
    want = fusedex.cross_entropy_bwd_plain(logits, targets, row_scale)
    b_ms, b_by = bound(logits.numel() * 4 * 2 + targets.numel() * 8 + N * 4, 5.0 * N * V, PEAK_F32_FLOPS)
    record("ce_bwd", shape, (got - want).abs().max().item(), row_rel_err(got, want), CE_BWD_ROW_REL,
           ms=time_ms(lambda: fusedex.cross_entropy_bwd(logits, targets, row_scale), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_bwd_plain(logits, targets, row_scale), 10),
           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del got, want, logits
    torch.cuda.empty_cache()


# The recompute-path backward against the plain recompute end to end: the
# two forwards' outputs differ by up to FLASH_ROW_REL, which moves Di = rowsum(
# dout*out) and with it every dS; twice the residual backward's limit. Set
# from that reasoning before any reading (the CUDA tests hold it too).
FLASH_RECOMPUTE_ROW_REL = 2.0 ** -4
# The masked cases of phase 3: (label, Tq, padding, causal). The path's own
# case first (row 0 left-padded by 512 tokens, causal): its timings are the
# row's. A key-padding mask (the "keypad" case) runs full attention, every
# query valid.
MASK_CASES = (("left512", SEQ, ("left", 0, 512), True), ("right300", SEQ, ("right", 1, 300), True),
              ("keypad", SEQ, ("left", 0, 512), False), ("Tq1024", SEQ // 2, ("left", 0, 512), True))


def _segments(B: int, Tq: int, Tkv: int, padding, causal: bool):
    """(q_seg, kv_seg) int32 on the card, 1 valid and 0 pad, as the flash
    executor's plan gives them: batch row ``padding[1]`` padded by
    ``padding[2]`` tokens on the ``padding[0]`` side; under a causal 4-D
    mask the queries are the last Tq key positions, under a key-padding
    mask every query is valid."""
    import torch

    side, row, n = padding
    kv = torch.ones((B, Tkv), dtype=torch.int32, device="cuda")
    if side == "left":
        kv[row, :n] = 0
    else:
        kv[row, Tkv - n:] = 0
    q = kv[:, Tkv - Tq:].contiguous() if causal else torch.ones((B, Tq), dtype=torch.int32, device="cuda")
    return q, kv


def _valid_pairs(q_seg, kv_seg, causal: bool) -> int:
    """(query, key) pairs between valid tokens that attention must compute
    (the bound's work): both segment ids 1, and j <= i + Tkv - Tq if causal."""
    import torch

    Tq, Tkv = q_seg.shape[1], kv_seg.shape[1]
    i = torch.arange(Tq, device="cuda")[:, None]
    j = torch.arange(Tkv, device="cuda")[None, :]
    vis = (q_seg[:, :, None] == 1) & (kv_seg[:, None, :] == 1)
    if causal:
        vis = vis & (j <= i + (Tkv - Tq))[None]
    return int(vis.sum().item())


def check_masked_kernels(cfg, rows: dict) -> None:
    """Kernel rows 9 (flash forward under segment ids) and 8 (the
    recompute-path backward) at the padded path's shapes, B=2, H=32,
    T=2048, D=100 bf16, q and k from rope and v a strided view: row 0
    left-padded by 512 tokens (the path's case, timed), a right-padded row,
    a key-padding mask (full attention) and Tq = 1024 over Tkv = 2048. Each
    against its plain version; then a planted fault (the segments ignored)
    must fail the forward's limit. Every row is compared, pad queries too."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    q_view, k_view, v, cos, sin = _path_inputs(cfg, B, gen)
    q_full, k = fusedex.apply_rope(q_view, cos, sin), fusedex.apply_rope(k_view, cos, sin)
    del q_view, k_view
    dout_full = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)

    def fold(name, label, err, rel, limit):
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["row_rel_err"] = max(row["row_rel_err"], rel)
        log(f"  {name:8s} {label:>8s} max_abs_err={err:.3e} row_rel_err={rel:.3e} (limit {limit:.3e})")
        require(rel <= limit, f"{name} kernel disagrees with its plain version at {label} ({rel} > {limit})")

    eps = 2.0 ** -7
    for label, Tq, padding, causal in MASK_CASES:
        q, dout = q_full[:, :, SEQ - Tq:], dout_full[:, :, SEQ - Tq:]
        q_seg, kv_seg = _segments(B, Tq, SEQ, padding, causal)
        seg = dict(q_seg=q_seg, kv_seg=kv_seg)

        # -- row 9: the forward under segment ids ----------------------------
        got = flashex.flash_attention_fwd_seg(q, k, v, q_seg, kv_seg, causal=causal, scale=scale)
        want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=causal, scale=scale, **seg)
        require(bool(torch.isfinite(got).all()), f"flash_fwd_seg produced non-finite values at {label}")
        err, rel = (got.float() - want_out.float()).abs().max().item(), row_rel_err(got, want_out)
        lse = torch.empty((B, H, Tq), dtype=torch.float32, device="cuda")
        out = flashex._launch_fwd(q, k, v, causal, scale, lse, q_seg, kv_seg)
        lse_rel = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        require(torch.equal(out, got) and lse_rel <= LSE_REL, f"flash_fwd_seg with lse at {label}: lse rel_err "
                                                              f"{lse_rel} (limit {LSE_REL})")
        pairs = _valid_pairs(q_seg, kv_seg, causal)
        seg_bytes = (q_seg.numel() + kv_seg.numel()) * 4
        if label == MASK_CASES[0][0]:
            mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
            mask &= torch.ones((Tq, SEQ), dtype=torch.bool, device="cuda").tril(SEQ - Tq)
            nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2 + seg_bytes
            b_ms, b_by = bound(nb, 4.0 * H * D * pairs, PEAK_BF16_FLOPS)
            _recorder(rows)(
                "flash_fwd_seg", label, err, rel, FLASH_ROW_REL, source="thunder_tpu_torch/csrc/flash_attn.cu",
                replaces="thunder_tpu/executors/flashex.py:355",
                ms=time_ms(lambda: flashex.flash_attention_fwd_seg(q, k, v, q_seg, kv_seg, causal=causal,
                                                                   scale=scale), 20),
                plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=causal, scale=scale, **seg),
                                 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 10))
            # The planted fault: the same inputs with the segments ignored.
            wrong = flashex.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
            planted = row_rel_err(wrong, want_out)
            log(f"  flash_fwd_seg planted fault (segments ignored): row_rel_err={planted:.3e} (must exceed "
                f"{FLASH_ROW_REL:.3e})")
            require(planted > FLASH_ROW_REL, "the masked-kernel comparison did not see the segments ignored")
            del wrong
        else:
            fold("flash_fwd_seg", label, err, rel, FLASH_ROW_REL)
        del got, want_out, want_lse

        # -- row 8: the recompute-path backward ------------------------------
        got = flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=causal, scale=scale, **seg)
        require(all(bool(torch.isfinite(g).all()) for g in got), f"flash_bwd_recompute non-finite at {label}")
        want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale, **seg)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        rel = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, want))
        del want
        e2e = flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal, scale=scale, **seg)
        rel_e2e = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, e2e))
        log(f"  flash_bwd_recompute {label}: against the plain recompute end to end row_rel_err={rel_e2e:.3e} "
            f"(limit {FLASH_RECOMPUTE_ROW_REL:.3e})")
        require(rel_e2e <= FLASH_RECOMPUTE_ROW_REL, f"flash_bwd_recompute differs from the plain recompute at {label}")
        del e2e
        if label == MASK_CASES[0][0]:
            # Read q, k, v, dout and the segments once; write dq, dk, dv once.
            nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()) * 2 + dout.numel() * 2 + seg_bytes
            b_ms, b_by = bound(nb, (4.0 + 10.0) * H * D * pairs, PEAK_BF16_FLOPS)
            qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

            def library():  # the same function in one PyTorch call each way: SDPA forward, autograd backward
                ref = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
                return torch.autograd.grad(ref, (qr, kr, vr), dout)

            _recorder(rows)(
                "flash_bwd_recompute", label, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
                replaces="thunder_tpu/executors/flashex.py:474",
                ms=time_ms(lambda: flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=causal, scale=scale,
                                                                         **seg), 10),
                plain_ms=time_ms(lambda: flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal,
                                                                                     scale=scale, **seg), 3, 1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10))
            del qr, kr, vr, mask
        else:
            fold("flash_bwd_recompute", label, err, rel, FLASH_BWD_ROW_REL)
        del got, out, lse
        torch.cuda.empty_cache()
    del q_full, k, v, dout_full
    torch.cuda.empty_cache()


def check_legacy_kernels(cfg, rows: dict) -> None:
    """Kernel row 10, the legacy route (``_legacy_flash``), at the training
    path's (2, 32, 2048, 100) bf16 causal, q and k from rope and v a strided
    view: its forward wrapper against ``flash_attention_plain`` (row 1's
    limit), its backward (the forward with lse, then the backward kernel)
    against the plain backward from that forward's (out, lse) (row 7's
    limit) and against the plain recompute end to end (row 8's)."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    q_view, k_view, v, cos, sin = _path_inputs(cfg, B, gen)
    q, k = fusedex.apply_rope(q_view, cos, sin), fusedex.apply_rope(k_view, cos, sin)
    del q_view, k_view
    dout = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    pairs = SEQ * (SEQ + 1) // 2
    record = _recorder(rows)

    got = flashex.legacy_flash_fwd(q, k, v, causal=True, scale=scale)
    want = flashex.flash_attention_plain(q, k, v, causal=True, scale=scale)
    require(bool(torch.isfinite(got).all()), "legacy_flash_fwd produced non-finite values")
    nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
    b_ms, b_by = bound(nb, 4.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("legacy_fwd", B, (got.float() - want.float()).abs().max().item(), row_rel_err(got, want), FLASH_ROW_REL,
           source="thunder_tpu_torch/csrc/flash_attn.cu", replaces="thunder_tpu/executors/flashex.py:422",
           ms=time_ms(lambda: flashex.legacy_flash_fwd(q, k, v, causal=True, scale=scale), 20),
           plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=True, scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
    del got, want

    eps = 2.0 ** -7
    got = flashex.legacy_flash_bwd(dout, q, k, v, causal=True, scale=scale)
    require(all(bool(torch.isfinite(g).all()) for g in got), "legacy_flash_bwd produced non-finite values")
    lse = torch.empty((B, H, SEQ), dtype=torch.float32, device="cuda")
    out = flashex._launch_fwd(q, k, v, True, scale, lse)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True, scale=scale)
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    rel = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, want))
    del want, out, lse
    e2e = flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=True, scale=scale)
    rel_e2e = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, e2e))
    log(f"  legacy_bwd: against the plain recompute end to end row_rel_err={rel_e2e:.3e} "
        f"(limit {FLASH_RECOMPUTE_ROW_REL:.3e})")
    require(rel_e2e <= FLASH_RECOMPUTE_ROW_REL, "legacy_flash_bwd differs from the plain recompute")
    del e2e
    # Read q, k, v and dout once; write dq, dk, dv once. The recomputed
    # forward's 4 FLOP per pair and the backward's 10.
    nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + dout.numel()) * 2
    b_ms, b_by = bound(nb, (4.0 + 10.0) * B * H * D * pairs, PEAK_BF16_FLOPS)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def library():  # the same function in one PyTorch call each way: SDPA forward, autograd backward
        ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        return torch.autograd.grad(ref, (qr, kr, vr), dout)

    record("legacy_bwd", B, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
           replaces="thunder_tpu/executors/flashex.py:422",
           ms=time_ms(lambda: flashex.legacy_flash_bwd(dout, q, k, v, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=True,
                                                                                scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10))
    del got, qr, kr, vr, q, k, v, dout
    torch.cuda.empty_cache()


# =============================================================================
# Phases 4 and 5: the whole path
# =============================================================================


def _wrappers() -> dict:
    """Each kernel's wrapper by row name. The rope backward is the rope
    kernel's wrapper: its launches are those made during a backward."""
    from thunder_tpu_torch.executors import flashex, fusedex, normex, quantex, rngex

    return {"int8_gemm": quantex.int8_gemm, "quantize_tensor": quantex.quantize_tensor,
            "quantize_rows": quantex.quantize_rows, "rng_draw": rngex.draw, "flash_fwd": flashex.flash_attention_fwd, "rope": fusedex.apply_rope,
            "ce_fwd": fusedex.cross_entropy_rows, "flash_fwd_lse": flashex.flash_attention_fwd_lse,
            "flash_bwd": flashex.flash_attention_bwd, "ce_bwd": fusedex.cross_entropy_bwd,
            "rms_fwd": normex.rms_norm_fwd, "rms_bwd": normex.rms_norm_bwd,
            "ln_fwd": normex.layer_norm_fwd, "ln_bwd": normex.layer_norm_bwd,
            "flash_fwd_seg": flashex.flash_attention_fwd_seg, "flash_bwd_recompute": flashex.flash_attention_bwd_recompute,
            "sdpa_exact": flashex.sdpa_exact, "legacy_fwd": flashex.legacy_flash_fwd,
            "legacy_bwd": flashex.legacy_flash_bwd}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


# The 2-layer model against the torch executor alone. The decomposition
# rounds q*scale and the scores to bf16 where the kernel keeps scores in f32,
# so logits differ by a few bf16 ulps; the limits are set from a sound run's
# readings (PERF.md) and a planted fault (attention without its causal mask)
# must exceed them, which shows that the comparison can see attention.
LOGITS_ROW_REL = 2.0 ** -4
LOSS_REL = 1e-4
# Gradients of the 2-layer loss, each param's held by its norm-relative
# error against the torch executor's (whose decomposed attention backward
# rounds its scores and probabilities to bf16 where the kernels keep f32);
# set from a sound run's reading (worst 2.58e-2, PERF.md), and a planted
# fault (the flash backward without its causal mask) must exceed it.
GRAD_REL = 2.0 ** -4


def check_two_layers(cfg) -> None:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.models import gpt

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED)
    idx_fwd = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (FWD_BATCH, SEQ))).cuda()
    idx = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()

    def run(executors):
        fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg2), executors=executors)
        loss = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        out = fwd(params, idx_fwd).float(), float(loss(params, idx, tgt))
        torch.cuda.synchronize()
        return out

    want_logits, want_loss = run(["torch"])

    def compare(label, logits, loss) -> bool:
        rel = row_rel_err(logits, want_logits)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        ok = math.isfinite(loss) and rel <= LOGITS_ROW_REL and loss_rel <= LOSS_REL
        log(f"  2-layer {label}: logits B={FWD_BATCH} max_abs_err={(logits - want_logits).abs().max().item():.3e} "
            f"row_rel_err={rel:.3e} (limit {LOGITS_ROW_REL:.3e}); loss B={LOSS_BATCH} {loss:.6f} vs torch "
            f"{want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}) -> {'pass' if ok else 'FAIL'}")
        return ok

    sound = compare("kernels", *run(None))
    real = flashex.flash_attention_fwd

    def planted(q, k, v, *, causal, scale):
        return real(q, k, v, causal=False, scale=scale)

    planted.launches = 0  # the kernel counts its launches on the module's name
    flashex.flash_attention_fwd = planted
    try:
        planted = compare("planted fault (flash without its causal mask)", *run(None))
    finally:
        flashex.flash_attention_fwd = real
    require(sound, "2-layer model with the kernels differs from the torch executor")
    require(not planted, "the 2-layer comparison did not see a planted attention fault")
    del want_logits

    # Gradients at B=2: value_and_grad with the default executors (flash
    # forward with lse and backward, CE backward, rope both ways) against the
    # torch executor alone.
    import torch.utils._pytree as pytree

    names = [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(params)[0]]

    def grads(executors):
        f = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        loss, g = f(params, idx, tgt)
        out = float(loss), [x.float() for x in g]
        torch.cuda.synchronize()
        return out

    want_gloss, want_grads = grads(["torch"])

    def compare_grads(label, loss, got) -> bool:
        rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(got, want_grads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        ok = math.isfinite(loss) and all(math.isfinite(r) for r in rels) and rels[worst] <= GRAD_REL
        log(f"  2-layer grads {label}: loss {loss:.6f} vs torch {want_gloss:.6f}; worst norm-relative error "
            f"{rels[worst]:.3e} on {names[worst]} (limit {GRAD_REL:.3e}); median {sorted(rels)[len(rels) // 2]:.3e} "
            f"-> {'pass' if ok else 'FAIL'}")
        return ok

    sound = compare_grads("kernels", *grads(None))
    real_bwd = flashex.flash_attention_bwd

    def planted_bwd(dout, q, k, v, out, lse, *, causal, scale):
        return real_bwd(dout, q, k, v, out, lse, causal=False, scale=scale)

    planted_bwd.launches = 0
    flashex.flash_attention_bwd = planted_bwd
    try:
        planted = compare_grads("planted fault (flash backward without its causal mask)", *grads(None))
    finally:
        flashex.flash_attention_bwd = real_bwd
    require(sound, "2-layer gradients with the kernels differ from the torch executor's")
    require(not planted, "the 2-layer gradient comparison did not see a planted attention-backward fault")
    del params, want_grads


def run_full(cfg) -> dict:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    # The jitted functions of phase 4 hold their inputs in reference cycles;
    # collect them so the peaks below are the full model's alone.
    gc.collect()
    log(f"  allocated before the full model: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params: {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED)
    launches = {k: 0 for k in _launch_counts()}

    def drive(label, fn, args, per_call, calls=3):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = _launch_counts()
        log(f"  {label}: first call (trace + eager warm-up) {times[0]:.3f} s, then (capture, replay) "
            f"{', '.join(f'{x:.4f}' for x in times[1:])} s/call; staged {tt.last_staging(fn).staged}; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
        for k, n in per_call.items():
            require(counts[k] == n * calls, f"{label}: {k} launched {counts[k]} times, expected {n * calls}")
        st = tt.last_staging(fn)
        require(st.staged and st.captures == 1 and st.replays == calls - 1, f"{label}: not staged as expected: {st}")
        for k in launches:
            launches[k] += counts[k]
        return out

    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    loss_fn = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    n = cfg.n_layer
    none = {"flash_fwd_lse": 0, "flash_bwd": 0, "ce_bwd": 0}
    loss = float(drive(f"loss B={LOSS_BATCH} T={SEQ}", loss_fn, (params, idx, tgt),
                       {"flash_fwd": n, "rope": 2 * n, "ce_fwd": 1, **none}))
    # Random init: logits ~ N(0, s^2) with s = 0.02 * sqrt(n_embd) ~ 1.13, so
    # the loss is about ln V + s^2 / 2 ~ 11.0.
    log(f"  loss = {loss:.6f} (ln V = {math.log(cfg.vocab_size):.4f})")
    require(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 2.0, "loss is not near ln V")
    report_dispatch(loss_fn, (params, idx, tgt), cfg)
    del loss_fn

    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (FWD_BATCH, SEQ))).cuda()
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg))
    logits = drive(f"forward B={FWD_BATCH} T={SEQ}", fwd, (params, idx),
                   {"flash_fwd": n, "rope": 2 * n, "ce_fwd": 0, **none})
    require(tuple(logits.shape) == (FWD_BATCH, SEQ, cfg.padded_vocab_size), f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "forward logits are not finite")
    return launches


def report_dispatch(loss_fn, args: tuple, cfg) -> None:
    """The host's time of a cache hit of the staged 26-layer loss (its
    params dict has 3 + 9 per layer tensor leaves), through each lookup:
    the slow tier (every prologue run, the fast table cleared before each
    call), the O(1) key (``cache_info``'s ``fast_hits``), and an entry of
    ``cache="same input"`` (no guard). Each: the lookup's own µs
    (``cache_lookup_ns``) and the call's until it returns, the graph's
    replay enqueued (no sync), the least of 5 calls."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    def hit_us(fn, clear: bool) -> tuple:
        cs = tt.compile_stats(fn)
        lookup, call = [], []
        for _ in range(5):
            if clear:
                cs.fast_cache.clear()
            n0, t = cs.cache_lookup_ns, time.perf_counter()
            fn(*args)
            call.append((time.perf_counter() - t) * 1e6)
            lookup.append((cs.cache_lookup_ns - n0) / 1e3)
            torch.cuda.synchronize()
        return min(lookup), min(call)

    fast0 = tt.cache_info(loss_fn)["fast_hits"]
    slow = hit_us(loss_fn, True)
    fast = hit_us(loss_fn, False)
    fast_hits = tt.cache_info(loss_fn)["fast_hits"] - fast0
    same = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), cache="same input")
    for _ in range(2):  # warm-up, capture
        same(*args)
    same_us = hit_us(same, False)
    torch.cuda.synchronize()
    leaves = sum(isinstance(x, torch.Tensor) for x in torch.utils._pytree.tree_leaves(args))
    log(f"  dispatch of a hit ({leaves} tensor leaves), host µs (lookup, call enqueued): slow tier (prologues) "
        f"{slow[0]:.1f}, {slow[1]:.1f}; fast tier (O(1) key) {fast[0]:.1f}, "
        f"{fast[1]:.1f}; cache='same input' {same_us[0]:.1f}, {same_us[1]:.1f}; cache_info fast_hits {fast_hits} of "
        f"the 5 fast-tier calls, slow_hits {tt.cache_info(loss_fn)['slow_hits']}")
    require(fast_hits == 5, f"the fast tier took {fast_hits} of 5 hits")
    require(tt.last_staging(same).staged and tt.compile_stats(same).cache_misses == 1,
            "the same-input entry did not stage or compiled twice")


# =============================================================================
# Phase 6: the training step
# =============================================================================

TRAIN_STEPS = 3


def staging_summary(label: str, losses: list, times: list, peak: int, prof: dict) -> dict:
    """Log one run of a training step: s/step (host clock around each step,
    ending in a synchronize), the enqueue ms, busy share and device ms of
    ``profile_call``'s timed and profiled calls, peak memory, the losses."""
    log(f"  {label}: {', '.join(f'{x:.4f}' for x in times)} s/step; profiled: wall "
        f"{', '.join(f'{x:.2f}' for x in prof['wall_ms'])} ms, enqueue {', '.join(f'{x:.2f}' for x in prof['enqueue_ms'])}"
        f" ms, device {prof['device_ms']:.2f} ms, busy {prof['busy_share']:.4f}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; loss {', '.join(f'{x:.6f}' for x in losses)}")
    return dict(losses=losses, times=times, peak=peak, wall_ms=prof["wall_ms"], enqueue_ms=prof["enqueue_ms"],
                device_ms=prof["device_ms"], busy=prof["busy_share"])


def compare_staging(label: str, eager: dict, staged: dict) -> None:
    """The staged step against the unstaged one from the same initial state:
    the first TRAIN_STEPS losses within LOSS_REL (the 2-layer loss limit),
    and whether they are bit-equal."""
    n = TRAIN_STEPS
    worst = max(abs(a - b) / abs(b) for a, b in zip(staged["losses"][:n], eager["losses"][:n]))
    log(f"  {label}: staged vs unstaged losses bit-equal {staged['losses'][:n] == eager['losses'][:n]}, "
        f"worst rel_err {worst:.3e} (limit {LOSS_REL:.0e}); s/step {min(staged['times'][2:]):.4f} vs "
        f"{min(eager['times'][1:]):.4f}; enqueue {min(staged['enqueue_ms']):.2f} vs {min(eager['enqueue_ms']):.2f} "
        f"ms; busy {staged['busy']:.4f} vs {eager['busy']:.4f}; peak {staged['peak'] / 2**30:.2f} vs "
        f"{eager['peak'] / 2**30:.2f} GiB")
    require(worst <= LOSS_REL, f"{label}: the staged step's losses differ from the unstaged step's")


def run_train(cfg, launches: dict) -> list:
    """``build_train`` on the full model at B=2, T=2048, then 3 unstaged
    steps. Each is driven through its parts (forward, backward, SGD), with
    the launch counts zeroed before and read after the forward and the
    backward, so the rope's forward and backward launches are told apart.
    Then the params are put back and the staged step (``Train.step``, one
    CUDA graph) runs 3 steps from the same state, its launches checked per
    step and its losses against the unstaged ones; then each step is timed
    and profiled (``profile_call``). Returns the unstaged losses."""
    import torch

    from thunder_tpu_torch.benchmarks import train
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.parallel.train import scalar_as

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = train.build_train(cfg, LOSS_BATCH, SEQ, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    passes = ", ".join(f"{k} {v:.3f} s" for k, v in tr.seconds.items())
    log(f"  build_train: {build_s:.3f} s with init_params; passes (first call): {passes}")
    fw_src, bw_src = tr.fw_trace.python(), tr.bw_trace.python()
    n = cfg.n_layer
    per_fw = {"flash_fwd_lse": fw_src.count("flash_sdpa_fwd_res("), "rope": fw_src.count("fused_apply_rope("),
              "ce_fwd": fw_src.count("fused_cross_entropy(")}
    per_bw = {"flash_bwd": bw_src.count("flash_sdpa_bwd_res("), "rope_bwd": bw_src.count("fused_apply_rope("),
              "ce_bwd": bw_src.count("fused_cross_entropy_bwd(")}
    params_in = {a.name for a in tr.fw_trace.args}
    saved = [p for p in tr.fw_trace.output[1] if p.name not in params_in]
    log(f"  claimed per step: forward {per_fw}, backward {per_bw}; saved for backward "
        f"{len(tr.fw_trace.output[1])} tensors, {len(saved)} of them not params, holding "
        f"{sum(p.size_bytes for p in saved) / 1e9:.2f} GB by the trace's shapes")
    require(per_fw == {"flash_fwd_lse": n, "rope": 2 * n, "ce_fwd": 1}
            and per_bw == {"flash_bwd": n, "rope_bwd": 2 * n, "ce_bwd": 1},
            "the training traces do not claim every attention, rope and cross-entropy op")

    initial = [p.detach().to("cpu") for p in tr.flat_params]  # host memory: the peaks below are the step's own
    weights = torch.cuda.memory_allocated()
    log(f"  allocated with the weights: {weights / 2**30:.2f} GiB")
    probe = tr.params["lm_head_w"]
    probe_i = next(i for i, p in enumerate(tr.flat_params) if p is probe)
    times, losses = [], []
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()  # steps 2.. hold no probe copies
        t = time.perf_counter()
        _zero_counts()
        loss, saved = tr.forward()
        fw_counts = _launch_counts()
        if step == 0:
            torch.cuda.synchronize()
            log(f"  after the forward: {(torch.cuda.memory_allocated() - weights) / 2**30:.2f} GiB above the weights "
                f"({len(saved)} saved tensors)")
        _zero_counts()
        grads = tr.backward(loss, saved)
        bw_counts = _launch_counts()
        if step == 0:
            p0, g0, ptr = probe.detach().clone(), grads[probe_i].clone(), probe.data_ptr()
        tr.sgd_(grads)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        got = {"flash_fwd_lse": fw_counts["flash_fwd_lse"], "rope": fw_counts["rope"], "ce_fwd": fw_counts["ce_fwd"],
               "flash_bwd": bw_counts["flash_bwd"], "rope_bwd": bw_counts["rope"], "ce_bwd": bw_counts["ce_bwd"]}
        require(got == {**per_fw, **per_bw}, f"train step {step + 1}: launches {got}, the traces claim "
                                             f"{ {**per_fw, **per_bw} }")
        require(fw_counts["flash_fwd"] == 0 and bw_counts["flash_fwd"] == 0, "the train step ran the plain flash "
                "forward instead of the one with logsumexp")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if step == 0:
            # SGD in place, bf16-true: the same four roundings, with the
            # scalars in bf16 as JAX's weak typing takes them, recomputed.
            upd = torch.mul(p0, scalar_as(train.WD, p0.dtype))
            upd = torch.add(g0, upd)
            upd.mul_(scalar_as(train.LR, p0.dtype))
            want = p0 - upd
            moved = (probe != p0).float().mean().item()
            log(f"  step 1 SGD on lm_head_w: in place {probe.data_ptr() == ptr}, equal to the recomputed update "
                f"{torch.equal(probe, want)}, {moved:.4%} of its bf16 values moved (|lr*g| is mostly below an ulp)")
            require(probe.data_ptr() == ptr and torch.equal(probe, want), "the SGD update of lm_head_w is wrong")
            require(moved > 0, "the SGD step moved no value of lm_head_w")
            del p0, g0, upd, want
    peak = torch.cuda.max_memory_allocated()
    log(f"  train B={LOSS_BATCH} T={SEQ}: step 1 {times[0]:.4f} s, then {', '.join(f'{x:.4f}' for x in times[1:])} "
        f"s/step; max_memory_allocated (steps 2-{TRAIN_STEPS}) = {peak / 2**30:.2f} GiB; "
        f"loss {', '.join(f'{x:.6f}' for x in losses)}; launches per step {got}")
    require(all(math.isfinite(x) and abs(x - math.log(cfg.vocab_size)) < 2.0 for x in losses),
            "training loss is not near ln V")
    eager_losses = losses
    eager = staging_summary("unstaged step", losses, times, peak, profile_call("train_step_unstaged", tr.step_eager,
                                                                               batch=LOSS_BATCH, seq=SEQ))
    staged = run_staged_train(tr, initial, {**per_fw, "rope": per_fw["rope"] + per_bw["rope_bwd"],
                                            "flash_bwd": per_bw["flash_bwd"], "ce_bwd": per_bw["ce_bwd"]}, launches)
    compare_staging(f"train B={LOSS_BATCH} T={SEQ}", eager, staged)
    return eager_losses, staged


def run_staged_train(tr, initial: list, per_step: dict, launches: dict) -> dict:
    """``tr``'s params put back to ``initial``, then ``Train.step`` (staged)
    for TRAIN_STEPS steps: the warm-up, the capture (with its first replay)
    and replays, each step's launches against ``per_step``; then timed and
    profiled replays. Returns its summary."""
    import torch

    with torch.no_grad():
        for p, p0 in zip(tr.flat_params, initial):
            p.copy_(p0)
    initial.clear()
    gc.collect()
    torch.cuda.empty_cache()
    times, losses = [], []
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()  # the capture's pool counts
        _zero_counts()
        t = time.perf_counter()
        loss = tr.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        counts = _launch_counts()
        got = {k: counts[k] for k in per_step}
        require(got == per_step, f"staged train step {step + 1}: launches {got}, the traces claim {per_step}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()
    st = tr.staging
    log(f"  staged step: warm-up {st.first_call_s:.3f} s, capture with its first replay {st.capture_s:.3f} s, "
        f"captures {st.captures}, replays {st.replays}, guard misses {st.guard_misses}, bytes copied per call "
        f"{st.copied_bytes_per_call}")
    require(st.staged and st.captures == 1 and st.guard_misses == 0, f"the train step did not stage: {st}")
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call

    return staging_summary("staged step", losses, times, peak,
                           profile_call("train_step_staged", tr.step, batch=LOSS_BATCH, seq=SEQ))


# =============================================================================
# Phase 7: pythia-410m at full width, 2 layers, with the norm executor
# =============================================================================

PYTHIA = "pythia-410m"
NORM_STACK = "norm,flash,fused,torch"
# The +norm stack against the torch executor alone. They hold attention's
# bf16 roundings apart as in phase 4, and the norm kernels apply the weight
# in f32 where the decomposition rounds the normed value first (one bf16
# ulp). Set from a sound run's readings (logits 1.28e-2, loss 5.4e-6, worst
# grad 1.03e-2; PERF.md): about 2.5 times each. A planted fault in the
# LayerNorm forward (no bias) must exceed the forward's limits, and one in
# its backward (no db) the gradients'.
PYTHIA_LOGITS_ROW_REL = 2.0 ** -5
PYTHIA_LOSS_REL = 2e-5
PYTHIA_GRAD_REL = 2.0 ** -5


def _perturbed_params(cfg, gen):
    """Random params whose norm weights and biases and linear biases are
    drawn away from their init (ones and zeros), so that a norm kernel that
    drops its bias, or a linear that drops its own, shows."""
    import torch

    from thunder_tpu_torch.models import gpt

    params = gpt.init_params(cfg, seed=SEED, device="cuda")

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "weight":  # a norm's weight
                v.add_((0.1 * torch.randn(v.shape, generator=gen, device="cuda")).to(v.dtype))
            elif k == "bias" or k.endswith("_b"):
                v.copy_(0.02 * torch.randn(v.shape, generator=gen, device="cuda"))

    for block in params["blocks"]:
        perturb(block)
    perturb(params["ln_f"])
    return params


def check_pythia_two_layers(cfg) -> None:
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import normex
    from thunder_tpu_torch.models import gpt

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = _perturbed_params(cfg2, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    idx = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    names = [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(params)[0]]
    stack = NORM_STACK.split(",")

    def run(executors):
        fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg2), executors=executors)
        vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        logits = fwd(params, idx).float()
        loss, g = vg(params, idx, tgt)
        out = logits, float(loss), [x.float() for x in g]
        torch.cuda.synchronize()
        if executors is not None and "norm" in executors:
            src = tt.last_traces(vg)[-1].python()
            n = 2 * cfg2.n_layer + 1
            require(src.count("norm_layer_norm(") == n and src.count("norm_layer_norm_bwd(") == n,
                    "the 2-layer +norm trace does not claim every LayerNorm")
        return out

    want_logits, want_loss, want_grads = run(["torch"])

    def compare(label, logits, loss, grads) -> tuple[bool, bool]:
        """(forward within its limits, gradients within theirs)."""
        rel = row_rel_err(logits, want_logits)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(grads, want_grads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        fwd_ok = math.isfinite(loss) and rel <= PYTHIA_LOGITS_ROW_REL and loss_rel <= PYTHIA_LOSS_REL
        grad_ok = all(math.isfinite(r) for r in rels) and rels[worst] <= PYTHIA_GRAD_REL
        log(f"  2-layer {label}: logits B={LOSS_BATCH} row_rel_err={rel:.3e} (limit {PYTHIA_LOGITS_ROW_REL:.3e}); "
            f"loss {loss:.6f} vs torch {want_loss:.6f} rel_err={loss_rel:.3e} (limit {PYTHIA_LOSS_REL:.0e}) -> "
            f"{'pass' if fwd_ok else 'FAIL'}; grads worst norm-relative error {rels[worst]:.3e} on {names[worst]} "
            f"(limit {PYTHIA_GRAD_REL:.3e}), median {sorted(rels)[len(rels) // 2]:.3e} -> "
            f"{'pass' if grad_ok else 'FAIL'}")
        return fwd_ok, grad_ok

    sound = compare("+norm", *run(stack))
    real_fwd, real_bwd = normex.layer_norm_fwd, normex.layer_norm_bwd

    def planted_fwd(x, weight, bias, eps=1e-5):
        return real_fwd(x, weight, None, eps)

    def planted_bwd(g, x, weight, eps=1e-5, *, with_bias):
        dx, dw, db = real_bwd(g, x, weight, eps, with_bias=with_bias)
        return dx, dw, None if db is None else torch.zeros_like(db)

    planted_fwd.launches = planted_bwd.launches = 0  # the kernels count their launches on the module's names
    seen = {}
    for part, label, name, fake in (
            (0, "planted fault (LayerNorm forward without its bias)", "layer_norm_fwd", planted_fwd),
            (1, "planted fault (LayerNorm backward without db)", "layer_norm_bwd", planted_bwd)):
        real = getattr(normex, name)
        setattr(normex, name, fake)
        try:
            seen[label] = not compare(label, *run(stack))[part]
        finally:
            setattr(normex, name, real)
    require(all(sound), "the 2-layer pythia model with the norm kernels differs from the torch executor")
    for label, failed in seen.items():
        require(failed, f"the 2-layer pythia comparison did not see a {label}")
    del params, want_grads, want_logits


# =============================================================================
# Phases 8 and 9: the LitGPT training benchmark (benchmarks/litgpt.py)
# =============================================================================

# Each claimed op of the joint trace and the kernel wrapper that runs it.
CLAIMED = {"flash_fwd_lse": "flash_sdpa_fwd_res(", "flash_bwd": "flash_sdpa_bwd_res(", "rope": "fused_apply_rope(",
           "ce_fwd": "fused_cross_entropy(", "ce_bwd": "fused_cross_entropy_bwd(", "rms_fwd": "norm_rms_norm(",
           "rms_bwd": "norm_rms_norm_bwd(", "ln_fwd": "norm_layer_norm(", "ln_bwd": "norm_layer_norm_bwd(",
           "flash_fwd": "flash_scaled_dot_product_attention("}


def run_litgpt(model: str, stack: str, expected: dict, launches: dict, *, optimizer: str, warmup: int,
               iters: int) -> dict:
    """``litgpt.run_one`` on ``model`` at B=2, T=2048 with the executors
    ``stack``: prints its summary, checks the claimed ops per step against
    ``expected`` and the launches of the run against the claims, and adds
    them to ``launches``. Returns the summary and the run (its state after
    the last step)."""
    import torch

    from thunder_tpu_torch.benchmarks import litgpt
    from thunder_tpu_torch.models import gpt

    gc.collect()
    torch.cuda.empty_cache()
    args = litgpt.parse_args(["--model", model, "--micro-batch", str(LOSS_BATCH), "--seq", str(SEQ),
                              "--iters", str(iters), "--warmup", str(warmup), "--optimizer", optimizer])
    t0 = time.perf_counter()
    run = litgpt.prepare(args, stack)
    torch.cuda.synchronize()
    src = run.extrace.python()
    claimed = {k: src.count(v) for k, v in CLAIMED.items()}
    log(f"  {model} [{stack}] built in {time.perf_counter() - t0:.3f} s (init_params, trace, claim); "
        f"claimed per step {claimed}")
    require(claimed == {k: expected.get(k, 0) for k in CLAIMED},
            f"{model} [{stack}]: the claimed trace holds {claimed}, expected {expected}")
    _zero_counts()
    summary = litgpt.run_one(args, stack, prepared=run)
    counts = _launch_counts()
    steps = warmup + iters
    log(f"  {json.dumps(summary)}")
    log(f"  {model} [{stack}]: {summary['median_iter_time_s']} s/iter (median of {iters}), "
        f"{summary['tokens_per_sec']} tokens/s, MFU {summary.get('mfu')} of 989 TFLOP/s, "
        f"peak {summary['memory_used_GB']} GB, loss {summary['loss_first']} -> {summary['loss_last']}; "
        f"launches over {steps} steps {counts}")
    for k, n in claimed.items():
        require(counts[k] == n * steps, f"{model} [{stack}]: {k} launched {counts[k]} times in {steps} steps, "
                                        f"the trace claims {n} a step")
        launches[k] = launches.get(k, 0) + counts[k]
    losses = [float(x) for x in run.losses]
    ln_v = math.log(gpt.name_to_config(model).vocab_size)
    require(all(math.isfinite(x) for x in losses) and abs(losses[0] - ln_v) < 2.0,
            f"{model} [{stack}]: the first loss {losses[0]} is not near ln V = {ln_v:.4f}")
    return summary, run


def compare_litgpt_staging(model: str, stack: str) -> None:
    """The LitGPT step of ``model`` (AdamW, ``stack``) unstaged
    (``step.eager``) and staged, each from a fresh ``litgpt.prepare`` (the
    same seed-0 weights and batch): TRAIN_STEPS steps each, then timed and
    profiled (``profile_call``); the losses compared."""
    import torch

    from thunder_tpu_torch.benchmarks import litgpt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call

    args = litgpt.parse_args(["--model", model, "--micro-batch", str(LOSS_BATCH), "--seq", str(SEQ)])
    out = {}
    for mode in ("unstaged", "staged"):
        gc.collect()
        torch.cuda.empty_cache()
        run = litgpt.prepare(args, stack)
        fn = run.step if mode == "staged" else run.step.eager
        state = [run.params, run.opt]

        def one():
            state[0], state[1], loss = fn(state[0], state[1], run.idx, run.tgt)
            return loss

        times, losses = [], []
        for i in range(TRAIN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = one()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        if mode == "staged":
            st = run.step.staging
            log(f"  staged step: warm-up {st.first_call_s:.3f} s, capture with its first replay {st.capture_s:.3f} s, "
                f"guard misses {st.guard_misses}, bytes copied per call {st.copied_bytes_per_call}")
            require(st.staged and st.captures == 1 and st.guard_misses == 0, f"the LitGPT step did not stage: {st}")
        out[mode] = staging_summary(f"{model} [{stack}] {mode} step", losses, times, peak,
                                    profile_call(f"litgpt_step_{mode}", one, batch=LOSS_BATCH, seq=SEQ, config=model,
                                                 executors=stack, optimizer="adamw"))
        del run, fn, state, one
    compare_staging(f"{model} [{stack}]", out["unstaged"], out["staged"])


def check_adamw_step(run) -> None:
    """One more step of ``run`` (a ``litgpt.prepare`` AdamW run), with
    lm_head_w's new value, moments and step count held against the AdamW
    formula recomputed here from its grad (the claimed program's own, at
    the same params): the JAX package's arithmetic in bf16, op by op."""
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.parallel.train import scalar_as

    lr, wd, b1, b2, eps = 3e-4, 0.1, 0.9, 0.95, 1e-8  # litgpt's --lr default; build_train_step's defaults
    p0, m0, v0 = run.params["lm_head_w"], run.opt["m"]["lm_head_w"].clone(), run.opt["v"]["lm_head_w"].clone()
    step0 = int(run.opt["step"])
    flat = tree_flatten(run.params)[0]
    i = next(j for j, p in enumerate(flat) if p is p0)
    with torch.no_grad():
        _, grads = run.step.loss_and_grads(*flat, run.idx, run.tgt)
    g = grads[i].float().to(p0.dtype)
    del grads, flat
    run.fn()
    r = lambda x: scalar_as(x, p0.dtype)  # noqa: E731
    m = m0 * r(b1) + g * r(1 - b1)
    v = v0 * r(b2) + (g * g) * r(1 - b2)
    t = torch.tensor(float(step0 + 1), device=p0.device)
    c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    update = (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps) + wd * p0.float()
    want = p0 - update.to(p0.dtype) * r(lr)
    p1, m1, v1 = run.params["lm_head_w"], run.opt["m"]["lm_head_w"], run.opt["v"]["lm_head_w"]
    ok = torch.equal(p1, want) and torch.equal(m1, m) and torch.equal(v1, v) and int(run.opt["step"]) == step0 + 1
    moved = (p1 != p0).float().mean().item()
    log(f"  AdamW step {step0 + 1} on lm_head_w: params, moments and step equal to the recomputed formula {ok} "
        f"(max |param diff| {(p1.float() - want.float()).abs().max().item():.3e}); {moved:.4%} of its values moved")
    require(ok, "the AdamW update of lm_head_w differs from the formula")
    require(moved > 0, "the AdamW step moved no value of lm_head_w")


# =============================================================================
# Phases 10 and 11: jit(nn.Module) on a padded batch (the Llama stand-in)
# =============================================================================

LLAMA_PAD = {0: 512}  # batch row 0 left-padded by 512 tokens
LLAMA_LR = 6e-4  # bench.py's SGD learning rate
# The ALiBi-like bias through the exact branch against the torch executor's
# decomposition, which rounds q*scale and the scores to bf16 where the exact
# branch keeps f32 scores: four bf16 ulps of the row's largest |value|.
EXACT_ROW_REL = 2.0 ** -5


def check_llama_two_layers() -> None:
    """The stand-in at open_llama_3b's full width with 2 layers through
    ``thunder_tpu_torch.jit(module)`` on the padded batch: the default
    executors against the torch executor alone, for the valid rows' logits
    (without grad), the loss and every parameter's gradient; then with the
    masked forward kernel ignoring its segments (the padding), and the
    recompute backward ignoring them, each of which must fail; then an
    ALiBi-like additive bias on SDPA, which must take the exact branch."""
    import torch.nn.functional as F

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import flashex

    cfg2 = replace(OPEN_LLAMA_3B, num_hidden_layers=2)
    m = llama(cfg2, seed=SEED, device="cuda")
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg2.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    valid = am.bool()

    def run(executors):
        tm = tt.jit(m, executors=executors)
        with torch.no_grad():
            logits = tm(ids, am)["logits"].float()
        out = tm(ids, am, labels)
        out["loss"].backward()
        grads = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        return logits, out["loss"].item(), grads

    want_logits, want_loss, want_grads = run(["torch"])

    def compare(label, logits, loss, grads) -> tuple[bool, bool]:
        rel = row_rel_err(logits[valid], want_logits[valid])
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        rels = {n: ((g - want_grads[n]).norm() / want_grads[n].norm().clamp_min(1e-30)).item() for n, g in grads.items()}
        worst = max(rels, key=rels.get)
        fwd_ok = math.isfinite(loss) and rel <= LOGITS_ROW_REL and loss_rel <= LOSS_REL
        grad_ok = all(math.isfinite(r) for r in rels.values()) and rels[worst] <= GRAD_REL
        log(f"  2-layer llama {label}: valid-row logits row_rel_err={rel:.3e} (limit {LOGITS_ROW_REL:.3e}); loss "
            f"{loss:.6f} vs torch {want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}); worst grad "
            f"norm-relative error {rels[worst]:.3e} on {worst} (limit {GRAD_REL:.3e}) -> forward "
            f"{'pass' if fwd_ok else 'FAIL'}, grads {'pass' if grad_ok else 'FAIL'}")
        return fwd_ok, grad_ok

    _zero_counts()
    sound = compare("kernels", *run(None))
    counts = _launch_counts()
    require(counts["flash_fwd_seg"] == 2 * 2 and counts["flash_bwd_recompute"] == 2 and counts["sdpa_exact"] == 0,
            f"2-layer llama: the masked kernels did not carry attention ({counts})")
    real_fwd, real_bwd = flashex.flash_attention_fwd_seg, flashex.flash_attention_bwd_recompute

    def planted_fwd(q, k, v, q_seg, kv_seg, *, causal, scale):
        return flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale)

    def planted_bwd(dout, q, k, v, *, causal, scale, q_seg=None, kv_seg=None):
        return real_bwd(dout, q, k, v, causal=True, scale=scale)

    planted_fwd.launches = planted_bwd.launches = 0
    flashex.flash_attention_fwd_seg = planted_fwd
    try:
        fault_fwd = compare("planted fault (forward without its padding)", *run(None))
    finally:
        flashex.flash_attention_fwd_seg = real_fwd
    flashex.flash_attention_bwd_recompute = planted_bwd
    try:
        fault_bwd = compare("planted fault (backward without its padding)", *run(None))
    finally:
        flashex.flash_attention_bwd_recompute = real_bwd
    require(all(sound), "2-layer llama with the kernels differs from the torch executor")
    require(not fault_fwd[0], "the 2-layer llama comparison did not see the forward's padding ignored")
    require(not fault_bwd[1], "the 2-layer llama gradient comparison did not see the backward's padding ignored")
    del m, want_logits, want_grads
    gc.collect()
    torch.cuda.empty_cache()

    # An ALiBi-like bias: additive, one slope, -inf above the diagonal. Its
    # entries are neither 0 nor <= -1e9, so the kernels cannot express it.
    class Biased(nn.Module):
        def forward(self, q, k, v, bias):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    H, D = OPEN_LLAMA_3B.num_attention_heads, OPEN_LLAMA_3B.head_dim
    q, k, v = (torch.randn((LOSS_BATCH, H, SEQ, D), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    i = torch.arange(SEQ, device="cuda")
    dist = (i[:, None] - i[None, :]).float()
    bias = torch.where(dist >= 0, -0.0625 * dist, -math.inf).to(torch.bfloat16)[None, None]
    _zero_counts()
    with torch.no_grad():
        got = tt.jit(Biased())(q, k, v, bias)
        counts = _launch_counts()
        want = tt.jit(Biased(), executors=["torch"])(q, k, v, bias)
    exact = flashex._exact_sdpa(q, k, v, bias, causal=False, scale=1.0 / math.sqrt(D))
    rel = row_rel_err(got, want)
    log(f"  ALiBi-like bias: exact branch taken {counts['sdpa_exact']} time(s), masked kernel "
        f"{counts['flash_fwd_seg']}; equal to the exact arithmetic {torch.equal(got, exact)}; against the torch "
        f"executor row_rel_err={rel:.3e} (limit {EXACT_ROW_REL:.3e})")
    require(counts["sdpa_exact"] == 1 and counts["flash_fwd_seg"] == 0 and counts["flash_fwd"] == 0,
            f"the ALiBi-like bias did not take the exact branch alone ({counts})")
    require(torch.equal(got, exact) and rel <= EXACT_ROW_REL, "the exact branch's values are wrong")


def run_llama(launches: dict) -> None:
    """The stand-in at open_llama_3b's full width and depth (26 layers) on
    the padded batch, B=2 x T=2048, through ``thunder_tpu_torch.jit``:
    the forward without grad (3 calls), the same on an all-ones mask (the
    value guard takes the unmasked causal path), and 3 training steps
    (loss with labels -100 at pads, ``.backward()``, ``torch.optim.SGD``),
    each with its launches checked against the claimed traces; then one
    profiled forward and step (``profile_gpt.profile_call``)."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.core.concrete import check_value_guards
    from thunder_tpu_torch.executors import flashex

    gc.collect()
    torch.cuda.empty_cache()
    cfg = OPEN_LLAMA_3B
    n = cfg.num_hidden_layers
    t0 = time.perf_counter()
    m = llama(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  llama init: {time.perf_counter() - t0:.2f} s, {sum(p.numel() for p in m.parameters()) / 1e9:.3f} B params, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    ones = torch.ones_like(am)
    tm = tt.jit(m)
    stats = tm._lc_cs

    def forward(mask):
        with torch.no_grad():
            return tm(ids, mask)["logits"]

    def drive(label, mask, per_call, calls):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        reads0, guards0 = flashex.mask_plan.host_reads, check_value_guards.host_reads
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            out = forward(mask)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = _launch_counts()
        reads = flashex.mask_plan.host_reads - reads0
        guard_reads = check_value_guards.host_reads - guards0
        log(f"  {label}: first call {times[0]:.3f} s, then {', '.join(f'{x:.4f}' for x in times[1:])} s/call; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; masks read {reads}, "
            f"value-guard reads {guard_reads}; launches {counts}")
        require(reads == 0, f"{label}: a mask was read on the host {reads} times; its verdict is the entry's")
        for k, v in per_call.items():
            require(counts[k] == v * calls, f"{label}: {k} launched {counts[k]} times, expected {v * calls}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, guard_reads

    none = {"flash_fwd_lse": 0, "flash_bwd": 0, "flash_bwd_recompute": 0, "sdpa_exact": 0, "ce_fwd": 0, "rope": 0}
    logits, reads = drive(f"forward padded B={LOSS_BATCH} T={SEQ}", am, {"flash_fwd_seg": n, "flash_fwd": 0, **none}, 3)
    require(tuple(logits.shape) == (LOSS_BATCH, SEQ, cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits[am.bool()]).all()), "padded forward: valid-row logits are not finite")
    require(reads == 2, f"the value guards were read {reads} times in 3 calls (the first compiles), expected 2")
    require((stats.cache_misses, stats.cache_hits) == (1, 2), "padded forward: expected 1 miss and 2 hits")
    src = tt.last_traces(tm)[-1].python()
    require(src.count("flash_scaled_dot_product_attention(") == n, "the padded forward does not claim every SDPA")
    del logits
    logits, reads = drive("forward all-ones mask", ones, {"flash_fwd": n, "flash_fwd_seg": 0, **none}, 2)
    require(bool(torch.isfinite(logits).all()), "all-ones forward: non-finite logits")
    require(reads == 2, f"all-ones forward: the value guards were read {reads} times, expected 2 (one entry each call)")
    require((stats.cache_misses, stats.cache_hits) == (2, 3), f"all-ones mask: cache misses/hits "
            f"{stats.cache_misses}/{stats.cache_hits}, expected 2/3 (the value guard's second entry)")
    forward(am)
    require((stats.cache_misses, stats.cache_hits) == (2, 4), "the padded entry was not found again")
    log(f"  value guard: cache misses {stats.cache_misses}, hits {stats.cache_hits}")
    del logits
    gc.collect()
    torch.cuda.empty_cache()

    opt = torch.optim.SGD(m.parameters(), lr=LLAMA_LR)
    weights = torch.cuda.memory_allocated()
    # The unstaged module's peak over the same steps, from the same state
    # of the card (the staged forward entries above hold their pools in
    # both), before the staged training entry exists.
    tm_eager = tt.jit(m, disable_jit_staging=True)
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        tm_eager(ids, am, labels)["loss"].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    times, losses = [], []
    per_fw = {"flash_fwd_seg": n, "ce_fwd": 1, "sdpa_exact": 0, "flash_fwd": 0, "flash_fwd_lse": 0}
    per_bw = {"flash_bwd_recompute": n, "ce_bwd": 1, "sdpa_exact": 0, "flash_bwd": 0, "flash_fwd_seg": 0}
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _zero_counts()
        out = tm(ids, am, labels)
        fw_counts = _launch_counts()
        _zero_counts()
        out["loss"].backward()
        bw_counts = _launch_counts()
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(out["loss"].item())
        del out
        if step == 0:
            fw_src, bw_src = tt.last_traces(tm)[-1].python(), stats.last_backward_traces[-1].python()
            claimed = {"flash_fwd_seg": fw_src.count("flash_scaled_dot_product_attention("),
                       "ce_fwd": fw_src.count("fused_cross_entropy("),
                       "flash_bwd_recompute": bw_src.count("flash_sdpa_bwd("),
                       "ce_bwd": bw_src.count("fused_cross_entropy_bwd(")}
            log(f"  train: claimed per step {claimed}; weights {weights / 2**30:.2f} GiB")
            require(claimed == {"flash_fwd_seg": n, "ce_fwd": 1, "flash_bwd_recompute": n, "ce_bwd": 1},
                    "the training traces do not claim every SDPA, SDPA backward and cross-entropy")
        for want, got in ((per_fw, fw_counts), (per_bw, bw_counts)):
            bad = {k: got[k] for k, v in want.items() if got[k] != v}
            require(not bad, f"train step {step + 1}: launches {bad}, expected {want}")
        for counts in (fw_counts, bw_counts):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()
    log(f"  llama train B={LOSS_BATCH} T={SEQ}: step 1 {times[0]:.4f} s, then "
        f"{', '.join(f'{x:.4f}' for x in times[1:])} s/step; max_memory_allocated (steps 2-{TRAIN_STEPS}) = "
        f"{peak / 2**30:.2f} GiB staged, {eager_peak / 2**30:.2f} GiB unstaged (this run, the same steps before "
        f"them); loss {', '.join(f'{x:.6f}' for x in losses)}")
    require(all(math.isfinite(x) and abs(x - math.log(cfg.vocab_size)) < 2.0 for x in losses),
            "llama training loss is not near ln V")
    require(losses[-1] < losses[0], "llama training loss did not fall")

    compare_llama_staging(m, tm, tm_eager, ids, am, labels)

    def step():
        out = tm(ids, am, labels)
        out["loss"].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    # The mask verdict's own cost: the checks over the path's (2, 1, 2048,
    # 2048) mask and the host read, on an idle card, for a fresh mask each
    # time (the memo would answer a repeat); the value guard runs the same
    # checks each call.
    mask = m.model.causal_mask(am, SEQ)
    q = torch.empty((LOSS_BATCH, cfg.num_attention_heads, SEQ, cfg.head_dim), dtype=torch.bfloat16, device="cuda")
    costs = []
    for _ in range(5):
        fresh = mask.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        plan = flashex.mask_plan(fresh, q, q, False)
        costs.append((time.perf_counter() - t) * 1e3)
    require(plan.flash and plan.causal, "the path's mask did not verify as causal∧padding")
    log(f"  mask verdict on the path's mask, idle card: {', '.join(f'{x:.3f}' for x in costs)} ms")
    del mask, q, fresh, plan

    reads0 = check_value_guards.host_reads
    profile_call("llama_forward_padded", lambda: forward(am), batch=LOSS_BATCH, seq=SEQ, config="open_llama_3b",
                 module="chip_smoke.LlamaForCausalLM", staged=True)
    staged_prof = profile_call("llama_train_step_padded", step, batch=LOSS_BATCH, seq=SEQ, config="open_llama_3b",
                               optimizer="sgd", module="chip_smoke.LlamaForCausalLM", staged=True)
    log(f"  value-guard reads over the profiled calls (one a call): {check_value_guards.host_reads - reads0}")

    def forward_eager():
        with torch.no_grad():
            return tm_eager(ids, am)["logits"]

    def step_eager():
        out = tm_eager(ids, am, labels)
        out["loss"].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    profile_call("llama_forward_padded_unstaged", forward_eager, batch=LOSS_BATCH, seq=SEQ, config="open_llama_3b",
                 module="chip_smoke.LlamaForCausalLM", staged=False)
    eager_prof = profile_call("llama_train_step_padded_unstaged", step_eager, batch=LOSS_BATCH, seq=SEQ,
                              config="open_llama_3b", optimizer="sgd", module="chip_smoke.LlamaForCausalLM", staged=False)
    # The device times compared come from steps traced on the device alone:
    # with the host's operators traced too (``profile_call``) a step's
    # kernels read 2-3.6% longer in all, by an amount that varies from one
    # profile to the next by as much as the limit. In turns,
    # staged, unstaged, unstaged, staged, twice: a drift of the card's
    # clocks over the eight profiles cancels in the two means.
    fns = {"staged": step, "unstaged": step_eager}
    dev: dict[str, list[float]] = {"staged": [], "unstaged": []}
    for which in ("staged", "unstaged", "unstaged", "staged") * 2:
        dev[which].append(kernel_ms(fns[which]))
    staged_ms = sum(dev["staged"]) / len(dev["staged"])
    eager_ms = sum(dev["unstaged"]) / len(dev["unstaged"])
    # The staged step at eager memory: its forward and backward graphs share
    # one pool, the backward reusing the saved activations as they die.
    gap = (peak - eager_peak) / 2**30
    dev_ratio = staged_ms / eager_ms
    log(f"  staged step against unstaged, this run: peak {peak / 2**30:.2f} vs {eager_peak / 2**30:.2f} GiB "
        f"({gap:+.2f} GiB, limit +{STAGED_PEAK_GAP_GIB:.0f}); device, host operators traced too, staged "
        f"{staged_prof['device_ms']:.2f}, unstaged {eager_prof['device_ms']:.2f} ms; device, kernels alone, staged "
        f"{', '.join(f'{x:.2f}' for x in dev['staged'])}, unstaged {', '.join(f'{x:.2f}' for x in dev['unstaged'])} "
        f"ms: means {staged_ms:.2f} vs {eager_ms:.2f} ({dev_ratio - 1:+.2%}, limit +{STAGED_DEVICE_RATIO - 1:.0%})")
    require(gap <= STAGED_PEAK_GAP_GIB, f"the staged module step's peak is {gap:.2f} GiB above the unstaged step's")
    require(dev_ratio <= STAGED_DEVICE_RATIO, f"the staged module step's device time is {dev_ratio - 1:.2%} above "
            "the unstaged step's")


def kernel_ms(fn) -> float:
    """The summed device time of the kernels of one call of ``fn``, traced
    with ``torch.profiler`` on the device alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) / 1e3


# The staged module step against the unstaged one in the same run: peak
# memory at most this far above (a pool shared by the forward and backward
# graphs; what is left is the capture stream's cuBLAS workspace and the
# copied outputs), device time at most this factor.
STAGED_PEAK_GAP_GIB = 1.0
STAGED_DEVICE_RATIO = 1.01


def compare_llama_staging(m, tm, tm_eager, ids, am, labels) -> None:
    """The staged module (``tm``: its forward and backward a CUDA graph
    each) against the same module jitted with ``disable_jit_staging=True``
    (``tm_eager``), from the same state: the forward without grad and a
    step's loss and grads, ``torch.equal``; the enqueue ms of each, from a
    call after the first (which traces, or warms up)."""
    cs = tm._lc_cs
    out = {}
    for label, fn in (("staged", tm), ("unstaged", tm_eager)):
        with torch.no_grad():
            logits = fn(ids, am)["logits"]
        enq = []
        for _ in range(2):
            m.zero_grad(set_to_none=True)
            t = time.perf_counter()
            res = fn(ids, am, labels)
            res["loss"].backward()
            enq.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        out[label] = (logits, res["loss"].detach(), [p.grad for p in m.parameters()], enq[-1])
        if label == "staged":
            fst, bst = cs.last_staging, cs.last_backward_staging
            require(fst.staged and bst.staged, f"the module step is not staged: forward {fst}, backward {bst}")
        del logits, res
    (l_s, loss_s, g_s, e_s), (l_e, loss_e, g_e, e_e) = out["staged"], out["unstaged"]
    same_fwd, same_loss = torch.equal(l_s, l_e), torch.equal(loss_s, loss_e)
    same_grads = all(torch.equal(a, b) for a, b in zip(g_s, g_e))
    log(f"  staged vs unstaged module: forward logits equal {same_fwd}, loss equal {same_loss} "
        f"({loss_s.item():.6f}), all {len(g_s)} grads equal {same_grads}; enqueue of a fw+bw step {e_s:.2f} ms staged "
        f"vs {e_e:.2f} ms unstaged; staged forward: captures {cs.last_staging.captures}, guard misses "
        f"{cs.last_staging.guard_misses}, bytes copied per call {cs.last_staging.copied_bytes_per_call}; backward: "
        f"captures {cs.last_backward_staging.captures}, guard misses {cs.last_backward_staging.guard_misses}, "
        f"bytes copied per call {cs.last_backward_staging.copied_bytes_per_call}")
    require(same_fwd and same_loss and same_grads, "the staged module differs from the unstaged module")
    m.zero_grad(set_to_none=True)


def run_legacy_train(cfg, splash_losses: list, launches: dict) -> None:
    """``build_train`` and 3 staged steps (``Train.step``) of the full
    open_llama_3b under ``THUNDER_FLASH_IMPL=legacy``: the claimed traces
    hold the legacy route (no residual pair), each step launches row 10's
    wrappers as often as they claim, and the losses are the splash route's
    of phase 6 (the same function) within LOSS_REL. The variable is
    restored afterwards."""
    import os

    import torch

    from thunder_tpu_torch.benchmarks import train

    gc.collect()
    torch.cuda.empty_cache()
    prev = os.environ.get("THUNDER_FLASH_IMPL")
    os.environ["THUNDER_FLASH_IMPL"] = "legacy"
    try:
        t0 = time.perf_counter()
        tr = train.build_train(cfg, LOSS_BATCH, SEQ, device="cuda", seed=SEED)
        build_s = time.perf_counter() - t0
        src = tr.fw_trace.python() + tr.bw_trace.python()
        per_step = {"legacy_fwd": src.count("flash_scaled_dot_product_attention("),
                    "legacy_bwd": src.count("flash_sdpa_bwd("), "flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd": 0,
                    "flash_bwd_recompute": 0}
        log(f"  build_train under legacy: {build_s:.3f} s; claimed per step {per_step}")
        n = cfg.n_layer
        require(per_step["legacy_fwd"] == n and per_step["legacy_bwd"] == n and "sdpa_fwd_res" not in src,
                "the legacy traces do not claim every attention and its recompute backward")
        times, losses = [], []
        for step in range(TRAIN_STEPS):
            if step == 1:
                torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t = time.perf_counter()
            loss = tr.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
            counts = _launch_counts()
            got = {k: counts[k] for k in per_step}
            require(got == per_step, f"legacy step {step + 1}: launches {got}, the traces claim {per_step}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated()
        st = tr.staging
        require(st.staged and st.captures == 1, f"the legacy train step did not stage: {st}")
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, splash_losses))
        log(f"  legacy train B={LOSS_BATCH} T={SEQ}, staged: {', '.join(f'{x:.4f}' for x in times)} s/step (warm-up, "
            f"capture, replay); max_memory_allocated (steps 2-{TRAIN_STEPS}) {peak / 2**30:.2f} GiB; loss "
            f"{', '.join(f'{x:.6f}' for x in losses)}; splash route's (phase 6) bit-equal {losses == splash_losses}, "
            f"worst rel_err {worst:.3e} (limit {LOSS_REL:.0e})")
        require(worst <= LOSS_REL, "the legacy route's losses differ from the splash route's")
        del tr
    finally:
        if prev is None:
            os.environ.pop("THUNDER_FLASH_IMPL", None)
        else:
            os.environ["THUNDER_FLASH_IMPL"] = prev


# =============================================================================
# Phase 13: open_llama_3b mixed-precision training (f32 weights, bf16 products)
# =============================================================================


# Rope in f32: x*cos + rot(x)*sin, where a fused multiply-add rounds once
# and the plain version twice: within a few f32 ulps (2^-23) of the row's
# largest |value|; four, set from that before any reading.
ROPE_F32_ROW_REL = 2.0 ** -21


def check_autocast_two_layers(cfg) -> None:
    """Rope on f32 rows at the path's shape against its plain version; then
    the 2-layer cut at full width with f32 weights under
    ``autocast="bfloat16"``: ``value_and_grad`` with the default executors
    against the torch executor alone, loss and every gradient at phase 4's
    limits (both run the products and attention in bf16)."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    # Rope on f32 rows, as autocast gives it q and k (rows 2 and 5 in f32):
    # the kernel against its plain version on the q view of an f32 qkv.
    from thunder_tpu_torch.executors import fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, _, _, cos, sin = _path_inputs(cfg, LOSS_BATCH, gen)
    qkv32 = q.float().permute(0, 2, 1, 3).reshape(LOSS_BATCH, SEQ, -1)  # a fresh f32 buffer
    q32 = qkv32.reshape(LOSS_BATCH, SEQ, cfg.n_head, cfg.head_size).permute(0, 2, 1, 3)
    for label, sign in (("rope", 1.0), ("rope_bwd", -1.0)):
        got = fusedex.apply_rope(q32, cos.float(), sign * sin.float())
        want = fusedex.rope_plain(q32, cos.float(), sign * sin.float())
        torch.cuda.synchronize()
        rel = row_rel_err(got, want)
        log(f"  {label} f32 {list(q32.shape)}: max_abs_err={(got - want).abs().max().item():.3e} row_rel_err={rel:.3e} "
            f"(limit {ROPE_F32_ROW_REL:.3e})")
        require(rel <= ROPE_F32_ROW_REL, f"{label} on f32 rows disagrees with its plain version")
    del q, q32, qkv32, got, want

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda", dtype=torch.float32)
    rng = np.random.RandomState(SEED)
    idx = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    names = [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(params)[0]]

    def grads(executors):
        f = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), autocast="bfloat16", executors=executors)
        loss, g = f(params, idx, tgt)
        torch.cuda.synchronize()
        require(all(x.dtype == torch.float32 for x in g), "autocast gradients of f32 weights are not f32")
        return float(loss), g

    want_loss, want = grads(["torch"])
    loss, got = grads(None)
    rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(got, want)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    ok = math.isfinite(loss) and loss_rel <= LOSS_REL and rels[worst] <= GRAD_REL
    log(f"  2-layer autocast: loss {loss:.6f} vs torch {want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}); "
        f"worst grad norm-relative error {rels[worst]:.3e} on {names[worst]} (limit {GRAD_REL:.3e}) -> "
        f"{'pass' if ok else 'FAIL'}")
    require(ok, "2-layer autocast gradients with the kernels differ from the torch executor's")


def run_autocast_train(cfg, launches: dict, bf16_staged: dict) -> None:
    """open_llama_3b at full width and depth with f32 weights from the seed:
    ``value_and_grad(loss_fn, autocast="bfloat16")`` and the f32 SGD update
    (``parallel.train.sgd_update``, in place), the whole step staged as one
    CUDA graph. 3 steps unstaged (the same step with the entry under
    ``disable_jit_staging=True`` and no graph), the params put back, 3 staged
    steps: launches of the claimed kernels per step against the trace (rope
    on f32 rows), losses bit-equal; then the staged step timed and profiled
    beside phase 6's bf16 staged step."""
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks import train
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.executors import staging
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel.train import sgd_update

    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    flat = tree_flatten(params)[0]
    log(f"  f32 weights: {sum(p.numel() for p in flat) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.RandomState(SEED)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), autocast="bfloat16", disable_jit_staging=True)

    def step(p, i, t):
        loss, grads = vg(p, i, t)
        sgd_update(tree_flatten(p)[0], list(grads), train.LR, train.WD, in_place=True)
        return loss

    staged = staging.CudaGraphStage(step, name="open_llama_3b autocast step")
    initial = [p.detach().to("cpu") for p in flat]
    n = cfg.n_layer
    per_step = None

    def run(fn, label):
        nonlocal per_step
        losses, times = [], []
        for k in range(TRAIN_STEPS):
            if k == 1:
                gc.collect()
                torch.cuda.empty_cache()  # the warm-up's cached blocks: the graph's pool is private
                torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t = time.perf_counter()
            loss = fn(params, idx, tgt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
            counts = _launch_counts()
            if per_step is None:
                trc = tt.last_traces(vg)[-1]
                src = trc.python()
                ropes = [b for b in trc.bound_symbols if b.sym.name == "apply_rope"]
                require(ropes and all(b.args[0].dtype.name == "float32" for b in ropes),
                        "autocast: the rope claims do not run on f32 rows")
                per_step = {"rope": src.count("fused_apply_rope("), "flash_fwd_lse": src.count("flash_sdpa_fwd_res("),
                            "flash_bwd": src.count("flash_sdpa_bwd_res("), "ce_fwd": src.count("fused_cross_entropy("),
                            "ce_bwd": src.count("fused_cross_entropy_bwd("), "flash_fwd": 0}
                log(f"  claimed per step: {per_step} (rope on f32 rows, attention on bf16 casts)")
                require(per_step == {"rope": 4 * n, "flash_fwd_lse": n, "flash_bwd": n, "ce_fwd": 1, "ce_bwd": 1,
                                     "flash_fwd": 0}, "the autocast step does not claim every rope, SDPA and CE op")
            got = {k2: counts[k2] for k2 in per_step}
            require(got == per_step, f"{label} step {k + 1}: launches {got}, the trace claims {per_step}")
            for k2, v in got.items():
                launches[k2] = launches.get(k2, 0) + v
        peak = torch.cuda.max_memory_allocated()
        log(f"  {label}: {', '.join(f'{x:.4f}' for x in times)} s/step; max_memory_allocated (steps 2-{TRAIN_STEPS}) "
            f"{peak / 2**30:.2f} GiB; loss {', '.join(f'{x:.6f}' for x in losses)}")
        require(all(math.isfinite(x) and abs(x - math.log(cfg.vocab_size)) < 2.0 for x in losses),
                f"{label}: loss is not near ln V")
        return losses, times, peak

    eager_losses, _, eager_peak = run(step, "unstaged autocast step")
    with torch.no_grad():
        for p, p0 in zip(flat, initial):
            p.copy_(p0)
    initial.clear()
    gc.collect()
    torch.cuda.empty_cache()
    losses, times, peak = run(staged, "staged autocast step")
    st = staged.stats
    require(st.staged and st.captures == 1 and st.guard_misses == 0, f"the autocast step did not stage: {st}")
    require(losses == eager_losses, f"staged autocast losses {losses} are not bit-equal to the unstaged {eager_losses}")
    prof = profile_call("autocast_train_step_staged", lambda: staged(params, idx, tgt), batch=LOSS_BATCH, seq=SEQ,
                        config=CFG_NAME, weights="float32", autocast="bfloat16", optimizer="sgd")
    log(f"  autocast step staged: {min(prof['wall_ms']):.2f} ms/step (wall, profiled run's timed calls), enqueue "
        f"{min(prof['enqueue_ms']):.2f} ms, device {prof['device_ms']:.2f} ms, busy {prof['busy_share']:.4f}, peak "
        f"{peak / 2**30:.2f} GiB (unstaged {eager_peak / 2**30:.2f}); losses bit-equal to unstaged True; "
        f"phase 6 bf16 step staged {min(bf16_staged['wall_ms']):.2f} ms/step, enqueue "
        f"{min(bf16_staged['enqueue_ms']):.2f} ms, peak {bf16_staged['peak'] / 2**30:.2f} GiB")
    del params, flat, staged, vg


# =============================================================================
# Phase 14: keyed random draws (csrc/rng.cu) and a staged dropout
# =============================================================================


def check_draw_kernel(rows: dict) -> None:
    """The draw kernel against its plain version at open_llama_3b's
    activation shape (2, 2048, 3200) and at the logits' (4096, 32000), in
    bf16 and f32: uniform draws bit-equal (the same integer hash, the same
    roundings), normal draws within 1e-5 of |x| + 1 or two bf16 ulps
    (erfinvf against torch's erfinv); timed beside the plain version and ``torch.rand`` (a yardstick
    only: other bits)."""
    import torch

    from thunder_tpu_torch.executors import rngex

    record = _recorder(rows)
    key = torch.tensor(rngex.prng_key_words(SEED + 1), dtype=torch.int64, device="cuda")
    for shape in ((LOSS_BATCH, SEQ, 3200), (LOSS_BATCH * SEQ, 32000)):
        for dtype in (torch.bfloat16, torch.float32):
            got = rngex.draw(key, 3, shape, dtype)
            want = rngex.draw_plain(key, 3, shape, dtype)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            err = (got.float() - want.float()).abs().max().item()
            require(same, f"rng_draw {dtype} {shape}: {(got != want).sum().item()} of {got.numel()} values differ")
            gn = rngex.draw(key, 4, shape, dtype, normal=True)
            wn = rngex.draw_plain(key, 4, shape, dtype, normal=True)
            # CUDA's erfinvf against torch's erfinv: 1e-5 of |x| + 1 (the two
            # erfinv implementations of the CPU tests), or two ulps of bf16.
            n_limit = max(2 * torch.finfo(dtype).eps, 1e-5)
            n_err = ((gn.float() - wn.float()).abs() / (wn.float().abs() + 1.0)).max().item()
            require(n_err <= n_limit, f"rng_draw normal {dtype} {shape}: {n_err} > {n_limit}")
            del gn, wn, got, want
            n = math.prod(shape)
            b_ms, b_by = bound(n * dtype.itemsize + 16, RNG_OPS_PER_ELEMENT * n, PEAK_INT32_OPS)
            ms = time_ms(lambda: rngex.draw(key, 3, shape, dtype), 20)
            # One call: the plain version queues some 300 launches, and a
            # longer run fills the launch queue behind time_ms's sleep.
            plain_ms = time_ms(lambda: rngex.draw_plain(key, 3, shape, dtype), 1, warmup=1)
            rand_ms = time_ms(lambda: torch.rand(shape, dtype=dtype, device="cuda"), 20)
            label = f"{str(dtype).removeprefix('torch.')}{list(shape)}"
            log(f"  rng_draw {label}: normal draws within {n_err:.2e} (limit {n_limit:.2e}); torch.rand (other bits, "
                f"a yardstick) {rand_ms:.4f} ms; {n * RNG_OPS_PER_ELEMENT / ms / 1e9:.2f} TOP/s of threefry")
            record("rng_draw", label, err, 0.0 if same else 1.0, 0.0, source="thunder_tpu_torch/csrc/rng.cu",
                   replaces="thunder_tpu/executors/jaxex.py:89 (jax.random under jax.jit; no TPU kernel)", ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def run_dropout(launches: dict) -> None:
    """``jit(F.dropout(x, 0.1))`` on open_llama_3b's activations (2, 2048,
    3200) bf16, staged: 4 calls after ``seed``, each drawing a fresh mask
    through the draw kernel; the same 4 calls unstaged after the same seed
    give ``torch.equal`` outputs; the keep rate within 5 sigma of its
    expectation. A bf16 draw has 8 random bits (7 of mantissa), so u takes
    the values k/128 and u < bf16(0.9) keeps 115 of them: the expectation
    is 115/128 = 0.8984375, not 0.9."""
    import torch
    import torch.nn.functional as F

    import thunder_tpu_torch as tt

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((LOSS_BATCH, SEQ, 3200), generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.where(x == 0, torch.ones_like(x), x)  # a kept element is then never 0
    staged = tt.jit(lambda x: F.dropout(x, 0.1))
    eager = tt.jit(lambda x: F.dropout(x, 0.1), disable_jit_staging=True)
    calls = 4
    tt.seed(SEED)
    _zero_counts()
    got = [staged(x) for _ in range(calls)]
    torch.cuda.synchronize()
    counts = _launch_counts()
    st = tt.last_staging(staged)
    require(st.staged and (st.captures, st.replays) == (1, calls - 1), f"dropout did not stage: {st}")
    require(counts["rng_draw"] == calls, f"dropout: rng_draw launched {counts['rng_draw']} times in {calls} calls")
    launches["rng_draw"] = launches.get("rng_draw", 0) + counts["rng_draw"]
    require("rng_key" in tt.last_traces(staged)[-1].python(), "the dropout trace takes no key")
    masks = [g != 0 for g in got]
    fresh = all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))
    tt.seed(SEED)
    same = all(torch.equal(g, eager(x)) for g in got)
    thr = float(torch.tensor(0.9, dtype=torch.bfloat16))
    p = sum(1 for k in range(128) if k / 128 < thr) / 128
    n = x.numel()
    sigma = math.sqrt(p * (1 - p) / n)
    rates = [m.float().mean().item() for m in masks]
    worst = max(abs(r - p) for r in rates) / sigma
    log(f"  dropout p=0.1 bf16 {list(x.shape)}: {calls} calls staged (captures {st.captures}, replays {st.replays}); "
        f"a fresh mask each call {fresh}; staged == unstaged after seed {same}; keep rates "
        f"{', '.join(f'{r:.6f}' for r in rates)}, expected {p} (worst {worst:.2f} sigma; 0.9 is "
        f"{abs(0.9 - p) / sigma:.1f} sigma away)")
    require(fresh, "a staged replay repeated the previous call's mask")
    require(same, "staged dropout draws differ from the unstaged ones after the same seed")
    require(worst <= 5.0, f"the keep rate is {worst:.2f} sigma from its expectation")


# =============================================================================
# Phase 3 (int8 row), 15: the int8 linear (executors/quantex.py, csrc/int8_gemm.cu)
# =============================================================================

PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
QUANT_STACK = ["quant", "flash", "fused", "torch"]
# open_llama_3b's five products at M = B*T = 4096: (label, N, K).
INT8_SHAPES = (("qkv", 9600, 3200), ("attn proj", 3200, 3200), ("fc_1, fc_2", 8640, 3200),
               ("mlp proj", 3200, 8640), ("lm_head", 32000, 3200))
# The int8 training step against phase 6's bf16 step from the same seed and
# data. Step 1 runs both on the same weights: int8 products move each
# linear's output by about 1% (per-tensor activation and per-row weight
# scales, 127 levels) and the mean loss over 4096 tokens by about 1e-3
# (relative); the limit is twice that. Later steps compare two trajectories
# (the straight-through grads see the int8 forward), so they are held to
# training, not to equality: the int8 loss falls every step, by at least
# half of the bf16 step's fall.
QUANT_LOSS_REL = 2e-3
QUANT_FALL_SHARE = 0.5


def check_int8_kernel(rows: dict) -> None:
    """The int8 GEMM (``quantex.int8_gemm``, the ``wgmma``/TMA kernel at
    these shapes) against its plain version at open_llama_3b's five products
    with M = 4096, on the quantized values of random bf16 activations and
    weights, bf16 out: bit-equal (the int32 sums are exact, the epilogue
    rounds as the plain version does). Each timed beside its bound (2*M*N*K
    at 1,979 TOP/s int8 against the bytes at 3.35 TB/s), the plain version,
    the ``mma.sync`` kernel that ran these products before ("was", through
    ``quantex.int8_gemm_sync``), ``torch._int_mm`` (the int32 product alone,
    a yardstick) and the bf16 ``torch.matmul`` the quant stack replaces. A
    planted fault (the K tail left unread) must differ."""
    import torch

    from thunder_tpu_torch.executors import quantex

    record = _recorder(rows)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    M = LOSS_BATCH * SEQ
    for label, N, K in INT8_SHAPES:
        a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((N, K), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        qa, sa = quantex.quantize_per_tensor(a, 127.0)
        qw, sw = quantex.quantize_per_channel(w, 127.0)
        scale = sa * sw[:, 0]
        require(quantex.tma_describes(qa, qw), f"int8_gemm {label}: the path's operands do not take the TMA route")
        got = quantex.int8_gemm(qa, qw, scale, None, torch.bfloat16)
        want = quantex.int8_gemm_plain(qa, qw, scale, None, torch.bfloat16)
        was = quantex.int8_gemm_sync(qa, qw, scale, None, torch.bfloat16)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        require(same, f"int8_gemm {label}: {(got != want).sum().item()} of {got.numel()} values differ from the plain")
        require(torch.equal(was, want), f"int8_gemm_sync {label}: differs from the plain version")
        cut = K - 16
        fault = quantex.int8_gemm(qa[:, :cut].contiguous(), qw[:, :cut].contiguous(), scale, None, torch.bfloat16)
        require(not torch.equal(fault, want), f"int8_gemm {label}: the planted fault (K tail unread) went unseen")
        del got, want, fault, was
        b_ms, b_by = bound(M * K + N * K + 4 * N + 2 * M * N, 2 * M * N * K, PEAK_INT8_OPS)
        ms = time_ms(lambda: quantex.int8_gemm(qa, qw, scale, None, torch.bfloat16), 10)
        was_ms = time_ms(lambda: quantex.int8_gemm_sync(qa, qw, scale, None, torch.bfloat16), 10)
        plain_ms = time_ms(lambda: quantex.int8_gemm_plain(qa, qw, scale, None, torch.bfloat16), 2, warmup=1)
        int_mm_ms = _library_ms(lambda: torch._int_mm(qa, qw.t()))
        bf16_ms = time_ms(lambda: torch.matmul(a, w.t()), 10)
        log(f"  int8_gemm {label} (M={M}, N={N}, K={K}): {2 * M * N * K / ms / 1e9:.1f} TOP/s, "
            f"{b_ms / ms:.1%} of the bound; was (mma.sync) {was_ms:.4f} ms; torch._int_mm "
            f"{int_mm_ms if int_mm_ms is None else round(int_mm_ms, 4)} ms, bf16 torch.matmul {bf16_ms:.4f} ms; "
            f"the K-tail fault differs")
        if label == INT8_SHAPES[0][0]:  # V = 2 problems with a scale a problem, as a vmapped activation
            qa2, scale2 = qa.reshape(2, M // 2, K), torch.stack([scale, scale.flip(0)])
            got = quantex.int8_gemm(qa2, qw, scale2, None, torch.bfloat16)
            same = all(torch.equal(got[i], quantex.int8_gemm(qa2[i], qw, scale2[i], None, torch.bfloat16))
                       for i in range(2))
            p_ms = time_ms(lambda: quantex.int8_gemm(qa2, qw, scale2, None, torch.bfloat16), 10)
            log(f"  int8_gemm {label} over 2 problems with a scale a problem: {p_ms:.4f} ms against {ms:.4f} with "
                f"one scale ({p_ms / ms - 1:+.2%}); each problem bit-equal to its own call {same}")
            require(same, f"int8_gemm {label}: a problem differs from its own call")
            del got
        # The row's timing is its first check's: qkv, the first product a layer runs.
        record("int8_gemm", label, err, 0.0 if same else 1.0, 0.0, source="thunder_tpu_torch/csrc/int8_gemm.cu",
               replaces="thunder_tpu/executors/quantex.py:134 (lax.dot_general int8 x int8 -> int32; no Pallas kernel)",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=int_mm_ms)
        del a, w, qa, qw


# The quantization's inputs on the int8 path (M = 4096): the activations
# each linear quantizes per tensor, and the weights it quantizes per row;
# the first of each is its row's timed shape.
QUANT_ACTS = ((4096, 3200), (4096, 8640))
QUANT_WEIGHTS = tuple((N, K) for _, N, K in INT8_SHAPES)
# f32 operations an element: |x| and the max, the division, the rounding,
# the clamp.
QUANT_OPS_PER_ELEMENT = 4


def check_quant_kernels(rows: dict) -> None:
    """``quantex.quantize_tensor`` and ``quantex.quantize_rows`` against
    their plain versions at the int8 path's shapes, bf16 in: q and the
    scales bit-equal. A planted fault (products with the reciprocal in place
    of both divisions) must differ: per row it moves the scales' bits; one
    scale and bf16's few distinct quotients may leave a single tensor's bits
    as they were, so per tensor it must differ on at least one of the
    path's inputs (the activations, and a weight under
    ``per_channel_weights=False``). Each row is timed at its first shape
    beside its bound (the input read once, q written once, at 3.35 TB/s)
    and its plain version; no single PyTorch call computes the
    quantization with its own scale (library_ms null)."""
    import torch

    from thunder_tpu_torch.executors import quantex

    record = _recorder(rows)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    fault_seen = []
    for kind, shapes in (("tensor", QUANT_ACTS + QUANT_WEIGHTS[:1]), ("rows", QUANT_WEIGHTS)):
        kernel = quantex.quantize_tensor if kind == "tensor" else quantex.quantize_rows
        plain = quantex.quantize_per_tensor if kind == "tensor" else quantex.quantize_per_channel
        launch = quantex._quantize_tensor_launch if kind == "tensor" else quantex._quantize_rows_launch
        for i, shape in enumerate(shapes):
            x = (torch.randn(shape, generator=gen, device="cuda") * (1.0 if shape in QUANT_ACTS else 0.02)).to(
                torch.bfloat16)
            q, s = kernel(x, 127.0)
            qp, sp = plain(x, 127.0)
            fq, fs = launch(x, 127.0, fault_reciprocal=True)
            torch.cuda.synchronize()
            same = torch.equal(q, qp) and torch.equal(s, sp)
            differs = not (torch.equal(fq, qp) and torch.equal(fs, sp))
            fault_seen.append((kind, differs))
            log(f"  quantize_{kind} {shape}: q and scale bit-equal {same}; the reciprocal fault differs {differs} "
                f"(q {(fq != qp).sum().item()} of {q.numel()}, scales {(fs != sp).sum().item()} of {s.numel()})")
            require(same, f"quantize_{kind} {shape}: differs from its plain version")
            if kind == "rows":
                require(differs, f"quantize_rows {shape}: the planted fault (reciprocal products) went unseen")
            if i == 0:
                n = x.numel()
                b_ms, b_by = bound(3 * n + 4 * (shape[0] if kind == "rows" else 1), QUANT_OPS_PER_ELEMENT * n,
                                   PEAK_F32_FLOPS)
                ms = time_ms(lambda: kernel(x, 127.0), 20)
                plain_ms = time_ms(lambda: plain(x, 127.0), 5)
                log(f"  quantize_{kind} {shape}: {3 * n / ms / 1e9:.3f} TB/s, {b_ms / ms:.1%} of the bound")
                record(f"quantize_{kind}", str(shape), 0.0 if same else 1.0, 0.0 if same else 1.0, 0.0,
                       source="thunder_tpu_torch/csrc/quantize.cu",
                       replaces=("thunder_tpu/executors/quantex.py:99 (_quantize_per_tensor, an XLA fusion; "
                                 "no Pallas kernel)" if kind == "tensor" else
                                 "thunder_tpu/executors/quantex.py:108 (_quantize_per_channel, an XLA fusion; "
                                 "no Pallas kernel)"),
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
            del x, q, s, qp, sp, fq, fs
    require(any(d for k, d in fault_seen if k == "tensor"),
            "quantize_tensor: the planted fault (reciprocal products) went unseen on every path input")


def run_quant_train(cfg, launches: dict, bf16_losses: list) -> None:
    """open_llama_3b at full width and depth, B=2 x T=2048, bf16, through
    ``value_and_grad(loss_fn, executors=QUANT_STACK)``: every linear of the
    forward (26 x 5 + the lm_head: 131) through the quantization kernels and
    the int8 GEMM, the backward straight-through in bf16, and phase 6's
    bf16-true SGD, from phase 6's seed and data. First the loss with the
    kernels against the loss with their plain versions in their seats
    (bit-equal), and with a planted fault (the K tail unread) that must
    differ; then 3 steps unstaged and, from the same state, 3 staged as one
    CUDA graph: launches per step, losses bit-equal between the two, the
    first within QUANT_LOSS_REL of phase 6's bf16 step's and each later fall
    at least QUANT_FALL_SHARE of its; s/step, enqueue, peak memory and the
    device time by kernel group."""
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks import train
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.executors import quantex, staging
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel.train import sgd_update

    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    flat = tree_flatten(params)[0]
    idx = torch.from_numpy(np.random.RandomState(SEED).randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.roll(idx, -1, dims=1)
    n = cfg.n_layer
    per_fw = 5 * n + 1

    loss_fn = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), executors=QUANT_STACK, disable_jit_staging=True)
    seats = ("int8_gemm", "quantize_tensor", "quantize_rows")
    kernels = {k: getattr(quantex, k) for k in seats}
    l_kernel = float(loss_fn(params, idx, tgt))

    def plain_gemm(qa, qw, scale, bias, dtype):
        return quantex.int8_gemm_plain(qa, qw, scale, bias, dtype)

    def plain_tensor(x, qmax):
        return quantex.quantize_per_tensor(x, qmax)

    def plain_rows(w, qmax):
        return quantex.quantize_per_channel(w, qmax)

    def tail_unread(qa, qw, scale, bias, dtype):
        cut = qa.shape[1] - 16
        return kernels["int8_gemm"](qa[:, :cut].contiguous(), qw[:, :cut].contiguous(), scale, bias, dtype)

    plains = dict(zip(seats, (plain_gemm, plain_tensor, plain_rows)))
    for fn in (*plains.values(), tail_unread):
        fn.launches = 0  # the wrapper counts on whatever sits in its seat
    try:
        for k, fn in plains.items():
            setattr(quantex, k, fn)
        l_plain = float(loss_fn(params, idx, tgt))
        for k, fn in kernels.items():
            setattr(quantex, k, fn)
        quantex.int8_gemm = tail_unread
        l_fault = float(loss_fn(params, idx, tgt))
    finally:
        for k, fn in kernels.items():
            setattr(quantex, k, fn)
    src = tt.last_traces(loss_fn)[-1].python()
    claimed = src.count("quant_linear(")
    log(f"  quant loss: kernels {l_kernel:.6f}, plain versions in their seats {l_plain:.6f} (bit-equal "
        f"{l_kernel == l_plain}),"
        f" planted fault (K tail unread) {l_fault:.6f}; linears claimed by quant {claimed}")
    require(claimed == per_fw, f"the quant stack claims {claimed} linears of the loss, expected {per_fw}")
    require(l_kernel == l_plain, "the int8 kernels' loss differs from their plain versions'")
    require(l_fault != l_plain, "the planted fault (K tail unread) went unseen")
    del loss_fn

    vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), executors=QUANT_STACK, disable_jit_staging=True)

    def step(p, i, t):
        loss, grads = vg(p, i, t)
        sgd_update(tree_flatten(p)[0], list(grads), train.LR, train.WD, in_place=True)
        return loss

    staged = staging.CudaGraphStage(step, name="open_llama_3b int8 step")
    initial = [p.detach().to("cpu") for p in flat]

    def run(fn, label):
        losses, times = [], []
        for k in range(TRAIN_STEPS):
            if k == 1:
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t = time.perf_counter()
            loss = fn(params, idx, tgt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
            counts = _launch_counts()
            require(all(counts[s] == per_fw for s in seats) and counts["flash_fwd_lse"] == n
                    and counts["flash_bwd"] == n,
                    f"{label} step {k + 1}: {', '.join(f'{s} {counts[s]}' for s in seats)} (expected {per_fw} "
                    f"each), flash {counts['flash_fwd_lse']}/{counts['flash_bwd']} (expected {n})")
            for k2 in seats + ("flash_fwd_lse", "flash_bwd", "rope", "ce_fwd", "ce_bwd"):
                launches[k2] = launches.get(k2, 0) + counts[k2]
        peak = torch.cuda.max_memory_allocated()
        log(f"  {label}: {', '.join(f'{x:.4f}' for x in times)} s/step; max_memory_allocated (steps 2-{TRAIN_STEPS}) "
            f"{peak / 2**30:.2f} GiB; int8_gemm and each quantization's launches per step {per_fw}; loss {', '.join(f'{x:.6f}' for x in losses)}")
        return losses, times, peak

    eager_losses, _, eager_peak = run(step, "unstaged int8 step")
    with torch.no_grad():
        for p, p0 in zip(flat, initial):
            p.copy_(p0)
    initial.clear()
    gc.collect()
    torch.cuda.empty_cache()
    losses, _, peak = run(staged, "staged int8 step")
    st = staged.stats
    require(st.staged and st.captures == 1 and st.guard_misses == 0, f"the int8 step did not stage: {st}")
    require(losses == eager_losses, f"staged int8 losses {losses} are not bit-equal to the unstaged {eager_losses}")
    first = abs(losses[0] - bf16_losses[0]) / abs(bf16_losses[0])
    falls = [(a0 - a1) / (b0 - b1) for a0, a1, b0, b1 in zip(losses, losses[1:], bf16_losses, bf16_losses[1:])]
    prof = profile_call("quant_train_step_staged", lambda: staged(params, idx, tgt), batch=LOSS_BATCH, seq=SEQ,
                        config=CFG_NAME, executors=",".join(QUANT_STACK), optimizer="sgd")
    log(f"  int8 step staged: {min(prof['wall_ms']):.2f} ms/step (wall, profiled run's timed calls), enqueue "
        f"{min(prof['enqueue_ms']):.2f} ms, device {prof['device_ms']:.2f} ms, busy {prof['busy_share']:.4f}, by group "
        f"{ {k: round(v, 3) for k, v in prof['device_ms_by_group'].items()} }, peak "
        f"{peak / 2**30:.2f} GiB (unstaged {eager_peak / 2**30:.2f}); against phase 6's bf16 steps "
        f"{', '.join(f'{x:.6f}' for x in bf16_losses)}: step 1 rel {first:.3e} (limit {QUANT_LOSS_REL:.0e}), each "
        f"later fall {', '.join(f'{x:.3f}' for x in falls)} of the bf16 step's (limit {QUANT_FALL_SHARE})")
    require(first <= QUANT_LOSS_REL, f"the int8 step's first loss is {first:.3e} from the bf16 step's")
    require(all(x >= QUANT_FALL_SHARE for x in falls), f"the int8 loss does not fall with the bf16 loss: {falls}")
    del params, flat, staged, vg


# =============================================================================
# Phase 16: symbolic values on the serving path
# =============================================================================

SYM_LENGTHS = (2048, 1950, 2000, 1900)  # buckets (1920, 2048] and (1792, 1920] of 128
# A cropped output against the exact-shape jit at the same T. The two run
# the same ops on other shapes (M = 2*2048 rows against 2*T in every
# product), and cuBLAS sums a product in another order at each shape: bf16
# roundings apart that 26 layers compound, where phase 4's limit is set for
# 2 layers. The padded run is held bit-equal to the exact-shape run at the
# bucket's ceiling on the same tokens, which shows the padding exact; so
# what it prints against the exact run at T is what two unpadded runs of
# the two lengths differ by, and the limit is twice phase 4's.
SYM_ROW_REL = 2.0 ** -3


def run_symbolic_serving(cfg, launches: dict) -> None:
    """open_llama_3b's forward at full width and depth, B=2, under
    ``jit(forward, cache="symbolic values")`` with dim 1 of the tokens
    marked and 128-wide sequence buckets, over T = 2048, 1950, 2000, 1900:
    two buckets, one entry and one CUDA graph each, captured at the bucket's
    ceiling. Three passes: the first warms up and captures, the second
    completes the captures, the third only replays and is timed. Each
    cropped output bit-equal to an exact-shape jit at the bucket's ceiling
    on the same tokens, and within SYM_ROW_REL of one at the same T; the
    loss under padding (tokens and targets marked) bit-equal to the exact
    loss at the ceiling with the pad targets ignored, and within LOSS_REL of
    the exact loss; then the Llama stand-in, 2 layers, under
    ``jit(module, seq_bucket=128)`` at T = 1950 and 2000: one forward
    capture, logits against the exact-shape module."""
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.models import gpt

    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    leaf = len(tree_flatten(params)[0])  # the tokens' index among the tensor leaves
    fwd = lambda p, i: gpt.forward(p, i, cfg)  # noqa: E731
    sym = tt.jit(fwd, cache="symbolic values", symbolic_dims={leaf: (1,)}, buckets={"seq": 128})
    exact = tt.jit(fwd, disable_jit_staging=True)
    ids = {T: torch.from_numpy(np.random.RandomState(SEED + T).randint(0, cfg.vocab_size, (LOSS_BATCH, T))).cuda()
           for T in SYM_LENGTHS}
    n = cfg.n_layer
    times = {}
    for p in range(3):
        for T in SYM_LENGTHS:
            _zero_counts()
            t = time.perf_counter()
            out = sym(params, ids[T])
            torch.cuda.synchronize()
            times[T] = time.perf_counter() - t
            counts = _launch_counts()
            require(tuple(out.shape) == (LOSS_BATCH, T, cfg.padded_vocab_size), f"symbolic T={T}: shape {out.shape}")
            require(counts["flash_fwd"] == n and counts["rope"] == 2 * n, f"symbolic T={T}: launches {counts}")
            for k in ("flash_fwd", "rope"):
                launches[k] = launches.get(k, 0) + counts[k]
            if p == 0:
                ceil = -(-T // 128) * 128
                padded = torch.cat([ids[T], ids[T].new_zeros((LOSS_BATCH, ceil - T))], dim=1)
                same = torch.equal(out, exact(params, padded)[:, :T])
                err = row_rel_err(out, exact(params, ids[T]))
                log(f"  symbolic T={T}: cropped logits bit-equal to the exact-shape jit at the ceiling {ceil} on the "
                    f"same tokens {same}; against the exact-shape jit at T row_rel_err {err:.3e} (limit "
                    f"{SYM_ROW_REL:.3e})")
                require(same, f"symbolic T={T}: logits differ from the exact-shape run at the bucket's ceiling")
                require(err <= SYM_ROW_REL, f"symbolic T={T}: logits differ from the exact-shape run")
            del out
    cs = tt.compile_stats(sym)
    info = tt.cache_info(sym)
    stages = [e.staging for e in cs.cache_entries]
    log(f"  symbolic entries {[e['buckets'] for e in info['entries']]}: captures {[s.captures for s in stages]}, "
        f"replays {[s.replays for s in stages]}, guard misses {[s.guard_misses for s in stages]}; compiles "
        f"{info['compiles']}, hits {info['hits']}")
    require(info["compiles"] == 2 and all(s.staged and s.captures == 1 and s.guard_misses == 0 for s in stages),
            "symbolic serving: expected two entries, one capture each")
    for T in SYM_LENGTHS:
        ceil = -(-T // 128) * 128
        log(f"  symbolic T={T} (bucket ceiling {ceil}, padding waste {(ceil - T) / ceil:.2%}): "
            f"{times[T]:.4f} s/call (a replay)")
    del sym, exact

    T = SYM_LENGTHS[1]
    tgt = torch.roll(ids[T], -1, dims=1)
    lf = lambda p, i, t: gpt.loss_fn(p, i, t, cfg)  # noqa: E731
    sym_loss = tt.jit(lf, cache="symbolic values", symbolic_dims={leaf: (1,), leaf + 1: (1,)}, buckets={"seq": 128})
    got = [float(sym_loss(params, ids[T], tgt)) for _ in range(3)]
    exact_loss = tt.jit(lf, disable_jit_staging=True)
    want = float(exact_loss(params, ids[T], tgt))
    # The exact-shape loss at the ceiling with the pad rows' targets ignored:
    # what the padded program computes.
    pad = 2048 - T
    at_ceiling = float(exact_loss(params, torch.cat([ids[T], ids[T].new_zeros((LOSS_BATCH, pad))], 1),
                                  torch.cat([tgt, tgt.new_full((LOSS_BATCH, pad), -100)], 1)))
    rel = max(abs(g - want) / abs(want) for g in got)
    src = tt.last_traces(sym_loss)[-1].python()
    log(f"  loss under padding T={T} (ceiling 2048): {', '.join(f'{g:.6f}' for g in got)} against the exact "
        f"{want:.6f}, rel {rel:.3e} (limit {LOSS_REL:.0e}); bit-equal to the exact loss at the ceiling with the pad "
        f"targets ignored ({at_ceiling:.6f}) {all(g == at_ceiling for g in got)}; the CE kernel claimed "
        f"{'fused_cross_entropy(' in src}")
    require(all(g == at_ceiling for g in got), "the loss under padding differs from the exact loss at the ceiling")
    require(rel <= LOSS_REL, "the loss under padding differs from the exact loss")
    require("fused_cross_entropy(" in src, "the padded loss does not run the CE kernel")
    require(tt.last_staging(sym_loss).staged, "the symbolic loss did not stage")
    del sym_loss, params

    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = replace(OPEN_LLAMA_3B, num_hidden_layers=2)
    m = llama(cfg2, seed=SEED, device="cuda")
    tm = tt.jit(m, seq_bucket=128)
    ref = tt.jit(m, disable_jit_staging=True)
    with torch.no_grad():
        for T in (1950, 2000):
            x = torch.from_numpy(np.random.RandomState(T).randint(0, cfg2.vocab_size, (LOSS_BATCH, T))).cuda()
            got = tm(x)["logits"]
            err = row_rel_err(got, ref(x)["logits"])
            require(tuple(got.shape) == (LOSS_BATCH, T, cfg2.vocab_size) and err <= LOGITS_ROW_REL,
                    f"seq_bucket T={T}: shape {tuple(got.shape)}, row_rel_err {err:.3e}")
            log(f"  Llama stand-in, 2 layers, seq_bucket=128, T={T}: logits against the exact-shape module "
                f"row_rel_err {err:.3e}")
    st, cs = tt.compile_stats(tm).last_staging, tt.compile_stats(tm)
    log(f"  seq_bucket: cache misses {cs.cache_misses}, hits {cs.cache_hits}; forward captures {st.captures}, "
        f"replays {st.replays}")
    require(cs.cache_misses == 1 and st.staged and st.captures == 1, "seq_bucket: expected one entry, one capture")
    del m, tm, ref


# =============================================================================
# Phase 18: per-sample gradients (vmap, grad of vmap, jvp)
# =============================================================================

PS_SAMPLES = 2  # V: the vmapped samples, each (1, SEQ)
# The kernel whose call sites a claimed trace holds, by the op it claims.
CLAIM_ROWS = {"flash_sdpa_fwd_res(": "flash_fwd_lse", "flash_sdpa_bwd_res(": "flash_bwd",
              "fused_apply_rope(": "rope", "fused_cross_entropy(": "ce_fwd", "fused_cross_entropy_bwd(": "ce_bwd",
              "norm_rms_norm(": "rms_fwd", "norm_rms_norm_bwd(": "rms_bwd"}


def _claimed_sites(trace) -> dict:
    src = trace.python()
    return {row: src.count(op) for op, row in CLAIM_ROWS.items() if src.count(op)}


def _faulty_flash_fwd_lse():
    """A planted fault in the flash forward's batching rule: every slice
    attends slice 0's k and v."""
    from thunder_tpu_torch.executors import batching, flashex

    def vmap(apply, V, in_dims, q, k, v, causal, scale):
        k0, v0 = (batching.front(t, d, V)[:1].expand(V, *batching.front(t, d, V).shape[1:]) for t, d in
                  ((k, in_dims[1]), (v, in_dims[2])))
        out, lse = apply(batching.fold(q, in_dims[0], V), batching.fold(k0, 0, V), batching.fold(v0, 0, V), causal,
                         scale)
        return (batching.unfold(out, V), batching.unfold(lse, V)), (0, 0)

    return batching._rule("FaultyFlashFwdLseRule", lambda q, k, v, causal, scale: flashex.flash_attention_fwd_lse(
        q, k, v, causal=causal, scale=scale), vmap)


def _faulty_norm_bwd():
    """A planted fault in the norm backward's rule: the slices folded into one
    segment, so every slice gets the column sum over all of them."""
    from thunder_tpu_torch.executors import batching

    def vmap(apply, V, in_dims, g, x, weight, eps, layer_norm, with_bias, segments):
        dx, dw, db = apply(batching.fold(g, in_dims[0], V), batching.fold(x, in_dims[1], V), weight, eps, layer_norm,
                           with_bias, segments)
        expand = lambda t: None if t is None else t.unsqueeze(0).expand(V, *t.shape)  # noqa: E731
        return (batching.unfold(dx, V), expand(dw), expand(db)), (0, 0, None if db is None else 0)

    return batching._rule("FaultyNormBwdRule", batching._norm_bwd, vmap)


def run_per_sample(cfg, launches: dict) -> None:
    """Phase 18. (a) 2 layers at full width: ``vmap(grad(loss_fn))`` over V
    samples, default stack and ``+norm``, against ``grad(loss_fn)`` at B = 1
    on each sample (the jit path's wrappers) and against the same vmap under
    the torch executor alone, each param's grad held by its norm-relative
    error (phase 4's limit); a planted fault in a rule must fail. (b) 2
    layers: ``value_and_grad(vmap(loss_fn))`` against the sum of (a)'s
    per-sample grads; ``jvp`` with the grads as tangents against their
    squared norm, with no kernel launch. (c) 26 layers: ``vmap(grad)``
    staged, its launches a call against the claimed trace and the B = 1
    grad program's, s/call, enqueue, peak memory and device ms by group,
    beside ``grad(loss_fn)`` at B = 2 (the same tokens)."""
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.executors import _build, batching
    from thunder_tpu_torch.models import gpt

    V = PS_SAMPLES
    rng = np.random.RandomState(SEED + 18)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda")
    names = [torch.utils._pytree.keystr(k) for k, _ in torch.utils._pytree.tree_flatten_with_path(params)[0]]

    def loss2(p, i, t):
        return gpt.loss_fn(p, i, t, cfg2)

    def counted(fn, *args):
        _zero_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, {k: v for k, v in _launch_counts().items() if v}

    def worst(got, want, label) -> float:
        rels = [((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item()
                for g, w in zip(got, want)]
        k = max(range(len(rels)), key=rels.__getitem__)
        log(f"    {label}: worst norm-relative error {rels[k]:.3e} on {names[k]}")
        return rels[k]

    for stack in (None, NORM_STACK.split(",")):
        label = "default stack" if stack is None else NORM_STACK
        grad1 = tt.grad(loss2, executors=stack)
        per_sample = tt.vmap(grad1, in_axes=(None, 0, 0))
        got, n_vmap = counted(per_sample, params, idx, tgt)
        for k in launches:
            launches[k] = launches.get(k, 0) + n_vmap.get(k, 0)
        ref, n_one = [], {}
        for s in range(V):
            r, n = counted(grad1, params, idx[s], tgt[s])
            ref.append(r)
            n_one = n
        torch_ps = tt.vmap(tt.grad(loss2, executors=["torch"]), in_axes=(None, 0, 0))(params, idx, tgt)
        sites = _claimed_sites(tt.compile_stats(per_sample).last_traces[-1])
        log(f"  (a) 2 layers, {label}: vmap(grad) over V={V} x (1, {SEQ}); launches a call {n_vmap}, the B=1 grad "
            f"program's {n_one}, call sites in the claimed trace {sites}")
        require(n_vmap == n_one == sites, f"{label}: vmap launches {n_vmap} differ from B=1 {n_one} / trace {sites}")
        errs = []
        for s in range(V):
            errs.append(worst([g[s] for g in got], ref[s], f"sample {s} vs grad at B=1"))
            errs.append(worst([g[s] for g in got], [g[s] for g in torch_ps], f"sample {s} vs the torch executor"))
        if stack is not None:
            nw = [i for i, nm in enumerate(names) if "norm" in nm or "ln" in nm]
            dw = max(((got[i][s].float() - ref[s][i].float()).norm() / ref[s][i].float().norm()).item()
                     for i in nw for s in range(V))
            log(f"    per-sample norm weight grads ({len(nw)} params, shape (V, D) each): worst {dw:.3e}")
        require(max(errs) <= GRAD_REL, f"{label}: per-sample grads differ (limit {GRAD_REL:.3e})")
        # A planted fault in one rule must fail the comparison with B = 1.
        seat, faulty = (("flash_fwd_lse", _faulty_flash_fwd_lse()) if stack is None
                        else ("norm_bwd", _faulty_norm_bwd()))
        real = getattr(batching, seat)
        setattr(batching, seat, faulty)
        try:
            bad = tt.vmap(tt.grad(loss2, executors=stack), in_axes=(None, 0, 0))(params, idx, tgt)
            fault = max(worst([g[s] for g in bad], ref[s], f"planted fault in {seat}'s rule, sample {s}")
                        for s in range(V))
        finally:
            setattr(batching, seat, real)
        require(fault > GRAD_REL, f"the per-sample comparison did not see a planted fault in {seat}'s rule")
        del got, ref, torch_ps, bad, per_sample, grad1

    # (b) grad of vmap and jvp, 2 layers.
    per_sample = tt.vmap(tt.grad(loss2), in_axes=(None, 0, 0))(params, idx, tgt)
    (vals, summed), n_vg = counted(tt.value_and_grad(tt.vmap(loss2, in_axes=(None, 0, 0))), params, idx, tgt)
    for k in launches:
        launches[k] = launches.get(k, 0) + n_vg.get(k, 0)
    err = worst(summed, [g.sum(0) for g in per_sample], "(b) value_and_grad(vmap(loss)) vs the per-sample sum")
    losses = [float(tt.jit(loss2)(params, idx[s], tgt[s])) for s in range(V)]
    val_err = max(abs(float(vals[s]) - losses[s]) / abs(losses[s]) for s in range(V))
    log(f"  (b) values {[f'{float(v):.6f}' for v in vals]} vs jit(loss) {[f'{x:.6f}' for x in losses]} "
        f"(rel {val_err:.3e}); launches {n_vg}")
    require(err <= GRAD_REL and val_err <= LOSS_REL, "grad(vmap(loss)) is not the sum of the per-sample grads")
    lval, g1 = tt.value_and_grad(loss2)(params, idx[0], tgt[0])
    tangents = torch.utils._pytree.tree_unflatten(list(g1), torch.utils._pytree.tree_structure(params))
    want = sum(float((g.float() * g.float()).sum()) for g in g1)
    (jl, jt), n_jvp = counted(tt.jvp, loss2, (params, idx[0], tgt[0]), (tangents, 0, 0))
    jvp_rel = abs(float(jt) - want) / abs(want)
    log(f"  (b) jvp: loss {float(jl):.6f} (value_and_grad {float(lval):.6f}), tangent {float(jt):.6e} vs <grad, t> = "
        f"{want:.6e} (rel {jvp_rel:.3e}, limit {GRAD_REL:.3e}); kernel launches under jvp {n_jvp}; "
        f"{tt.compile_stats(tt.jvp).executors_note}")
    require(not n_jvp and jvp_rel <= GRAD_REL and abs(float(jl) - float(lval)) <= LOSS_REL * abs(float(lval)),
            "jvp disagrees with value_and_grad or launched a kernel")
    del params, per_sample, summed, g1, tangents
    gc.collect()
    torch.cuda.empty_cache()

    # (c) 26 layers, staged.
    params = gpt.init_params(cfg, seed=SEED, device="cuda")

    def loss(p, i, t):
        return gpt.loss_fn(p, i, t, cfg)

    grad = tt.grad(loss)
    per_sample = tt.vmap(grad, in_axes=(None, 0, 0))
    out, times, counts, mem = _three_calls(per_sample, params, idx, tgt)
    del out
    peak = max(m[2] for m in mem)
    log(f"  (c) {_mem_line(mem)}")
    st = tt.last_staging(per_sample)
    sites = _claimed_sites(tt.compile_stats(per_sample).last_traces[-1])
    _, n_one = counted(grad, params, idx[0], tgt[0])
    log(f"  (c) {cfg.n_layer} layers, vmap(grad) V={V} x (1, {SEQ}): {', '.join(f'{x:.4f}' for x in times)} s/call "
        f"(trace + warm-up, capture, replay); staged {st.staged}, captures {st.captures}; launches a call "
        f"{counts[-1]}, the trace's call sites {sites}, the B=1 grad's {n_one}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    require(st.staged and all(c == sites == n_one for c in counts), "the staged per-sample grads' launches differ")
    for k in launches:
        launches[k] = launches.get(k, 0) + sum(c.get(k, 0) for c in counts)
    prof = profile_call("per_sample_grads_staged", lambda: per_sample(params, idx, tgt), batch=V, seq=SEQ,
                        config=CFG_NAME)
    del per_sample
    gc.collect()
    torch.cuda.empty_cache()
    flat_idx, flat_tgt = idx.reshape(V, SEQ), tgt.reshape(V, SEQ)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        grad(params, flat_idx, flat_tgt)
    torch.cuda.synchronize()
    b2_peak = torch.cuda.max_memory_allocated()
    b2 = profile_call("grad_b2_staged", lambda: grad(params, flat_idx, flat_tgt), batch=V, seq=SEQ, config=CFG_NAME)
    for label, pr, pk in (("vmap(grad), V=2 x (1, 2048)", prof, peak), ("grad, B=2", b2, b2_peak)):
        log(f"  (c) {label}: {min(pr['wall_ms']):.2f} ms/call, enqueue {min(pr['enqueue_ms']):.2f} ms, device "
            f"{pr['device_ms']:.2f} ms, busy {pr['busy_share']:.4f}, by group "
            f"{ {k: round(v, 3) for k, v in pr['device_ms_by_group'].items()} }, peak {pk / 2**30:.2f} GiB")
    del params, grad
    gc.collect()
    torch.cuda.empty_cache()


# =============================================================================
# Phase 19: the last batching rules at full width
# =============================================================================

PS_PAD = 512  # sample 0 of phase 19 (a) left-padded by this many tokens, as phase 11's batch
ENSEMBLE_OFFSETS = (0, 512)  # each model's first position in phase 19 (b)
ENSEMBLE_LOGITS_REL = 2.0 ** -6  # batched products may sum in another order


def _fn_forward(params, idx, mask, cos, sin, cfg):
    """The GPT forward of ``models/gpt.py`` in functional form with an
    attention mask (None: causal) and the rope tables as inputs, for vmap
    over a padded batch and over per-sample positions. The smoke test's
    form, not a package feature."""
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.models import gpt

    B, T = idx.shape
    H, G, hs = cfg.n_head, cfg.query_groups, cfg.head_size
    x = ttorch.embedding(idx, params["wte"])
    for p in params["blocks"]:
        a = p["attn"]
        qkv = ttorch.linear(gpt._norm(x, p["norm_1"], cfg), a["qkv_w"], a.get("qkv_b"))
        q, k, v = (ttorch.permute(ttorch.reshape(t, (B, T, n, hs)), (0, 2, 1, 3)) for t, n in
                   ((qkv[..., :H * hs], H), (qkv[..., H * hs:(H + G) * hs], G), (qkv[..., (H + G) * hs:], G)))
        q, k = ttorch.apply_rope(q, cos, sin), ttorch.apply_rope(k, cos, sin)
        y = (ttorch.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=G != H) if mask is None else
             ttorch.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=G != H))
        x = x + ttorch.linear(ttorch.reshape(ttorch.permute(y, (0, 2, 1, 3)), (B, T, H * hs)), a["proj_w"],
                              a.get("proj_b"))
        x = x + gpt._mlp(gpt._norm(x, p["norm_2"], cfg), p["mlp"], cfg)
    return ttorch.linear(gpt._norm(x, params["ln_f"], cfg), params["lm_head_w"])


def _fn_loss(params, idx, tgt, mask, cos, sin, cfg):
    import thunder_tpu_torch.torch as ttorch

    logits = _fn_forward(params, idx, mask, cos, sin, cfg)
    B, T, V = logits.shape
    return ttorch.cross_entropy(ttorch.reshape(logits.float(), (B * T, V)), ttorch.reshape(tgt, (B * T,)))


def _rope_tables(cfg, T: int, offset: int = 0):
    """cos/sin (T, rope_n_elem) bf16 of positions offset .. offset + T."""
    import torch

    n = cfg.rope_n_elem
    theta = cfg.rope_base ** (-torch.arange(0, n // 2, dtype=torch.float64, device="cuda") * 2 / n)
    f = torch.arange(offset, offset + T, dtype=torch.float64, device="cuda")[:, None] * theta[None]
    emb = torch.cat([f, f], 1)
    return emb.cos().to(torch.bfloat16), emb.sin().to(torch.bfloat16)


def _padded_samples(cfg, V: int, seed: int, window: int = 0):
    """(idx, tgt, mask) for V samples of (1, SEQ): sample 0 left-padded by
    PS_PAD tokens (its targets there ignored), the others whole; mask (V,
    1, 1, SEQ, SEQ) bool, causal and the keys' padding. ``window`` > 0
    gives sample 1 a sliding-window causal mask of that width instead,
    which segment ids cannot express (the exact branch, verdict 0)."""
    import torch

    rng = np.random.RandomState(seed)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    tgt[0, 0, :PS_PAD] = -100
    kv = torch.ones((V, SEQ), dtype=torch.bool, device="cuda")
    kv[0, :PS_PAD] = False
    mask = torch.ones((SEQ, SEQ), dtype=torch.bool, device="cuda").tril()[None] & kv[:, None, :]
    if window:
        mask[1] &= torch.ones((SEQ, SEQ), dtype=torch.bool, device="cuda").triu(-(window - 1))
    return idx, tgt, mask[:, None, None]


def _three_calls(fn, *args) -> tuple:
    """A staged entry's warm-up, capture and replay, each call's output
    dropped before the next call (as a training loop drops its grads):
    (the last output, s a call, launches a call, (allocated before, after,
    peak) bytes a call)."""
    import torch

    out, times, counts, mem = None, [], [], []
    for _ in range(3):
        out = None
        _zero_counts()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        counts.append({k: v for k, v in _launch_counts().items() if v})
        mem.append((before, torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()))
    return out, times, counts, mem


def _mem_line(mem) -> str:
    return "memory_allocated before, after and peak of warm-up, capture, replay (GiB): " + "; ".join(
        "/".join(f"{x / 2**30:.3f}" for x in m) for m in mem)


def _count_calls(fn, *args):
    import torch

    _zero_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: v for k, v in _launch_counts().items() if v}


def _grad_gaps(got, wants, names) -> tuple:
    """(worst norm-relative gap over the slices, its param, params bit-equal of all)."""
    worst, where, equal, total = 0.0, "", 0, 0
    for s, want in enumerate(wants):
        for g, w, nm in zip(got, want, names):
            total += 1
            equal += int(torch_equal(g[s], w))
            rel = ((g[s].float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item()
            if rel > worst:
                worst, where = rel, f"{nm}[{s}]"
    return worst, where, f"{equal}/{total}"


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def run_masked_per_sample(cfg, launches: dict) -> dict:
    """Phase 19 (a). ``vmap(grad(loss))`` over V=2 x (1, 2048) with a padded
    4-D causal mask (sample 0 left-padded by 512): at 2 layers each sample's
    grads against ``grad`` at B=1 on it (how many bit-equal, the worst
    gap), rows 8-9 once a call site; a planted fault (one verdict shared by
    the slices, with a slice under a sliding-window mask) must fail; at 26
    layers staged, the gap against B=1, s/call, enqueue, device ms by group
    and peak memory beside ``grad`` at B=2 on the same tokens and mask.
    Returns what phase 20 (b) plans: the 26-layer vmap's trace and peak."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.executors import batching, flashex
    from thunder_tpu_torch.models import gpt

    V = PS_SAMPLES
    idx, tgt, mask = _padded_samples(cfg, V, SEED + 19)
    cos, sin = _rope_tables(cfg, SEQ)
    axes = (None, 0, 0, 0, None, None)
    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda")
    names = [torch.utils._pytree.keystr(k) for k, _ in torch.utils._pytree.tree_flatten_with_path(params)[0]]

    def loss2(p, i, t, m, c, s_):
        return _fn_loss(p, i, t, m, c, s_, cfg2)

    grad1 = tt.grad(loss2)
    per_sample = tt.vmap(grad1, in_axes=axes)
    got, n_vmap = _count_calls(per_sample, params, idx, tgt, mask, cos, sin)
    src = tt.compile_stats(per_sample).last_traces[-1].python()
    verdicts = sorted(set(re.findall(r"verdict=(\([0-9, ]+\))", src)))
    b1 = [int(flashex.mask_verdict(mask[s], 1, SEQ, SEQ, False)) for s in range(V)]
    wants = []
    for s in range(V):
        r, n_one = _count_calls(grad1, params, idx[s], tgt[s], mask[s], cos, sin)
        wants.append(r)
    worst, where, equal = _grad_gaps(got, wants, names)
    log(f"  (a) 2 layers: vmap(grad) over V={V} x (1, {SEQ}), sample 0 left-padded by {PS_PAD}: verdicts given to "
        f"the claims {verdicts}, B=1 verdicts {b1}; launches a call {n_vmap} (B=1 grad's {n_one}); grads bit-equal "
        f"to B=1 {equal}, worst norm-relative gap {worst:.3e} on {where} (limit {GRAD_REL:.3e})")
    require(n_vmap.get("flash_fwd_seg") == n_vmap.get("flash_bwd_recompute") == cfg2.n_layer
            and "sdpa_exact" not in n_vmap, f"rows 8-9 are not launched once a call site: {n_vmap}")
    require(worst <= GRAD_REL, "the masked per-sample grads differ from grad at B=1")
    for k in launches:
        launches[k] = launches.get(k, 0) + n_vmap.get(k, 0)
    del got, wants

    # The planted fault: the slices' verdicts replaced by slice 0's, with a
    # slice under a sliding-window mask (the exact branch at B=1).
    fidx, ftgt, fmask = _padded_samples(cfg, V, SEED + 19, window=256)
    vloss = tt.vmap(loss2, in_axes=axes)
    one = [float(tt.jit(loss2)(params, fidx[s], ftgt[s], fmask[s], cos, sin)) for s in range(V)]
    sound = [float(x) for x in vloss(params, fidx, ftgt, fmask, cos, sin)]
    real = batching._verdict_rows

    def shared(q, k, m4, causal, verdicts, groups):
        return real(q, k, m4, causal, None if verdicts is None else (tuple(verdicts)[0],) * groups, groups)

    batching._verdict_rows = shared
    try:
        faulty = [float(x) for x in tt.vmap(loss2, in_axes=axes)(params, fidx, ftgt, fmask, cos, sin)]
    finally:
        batching._verdict_rows = real
    gap = lambda xs: max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(xs, one))  # noqa: E731
    log(f"  (a) slice 1 under a 256-wide sliding window: B=1 losses {one}, vmap {sound} (gap {gap(sound):.3e}), planted fault "
        f"(one verdict shared) {faulty} (gap {gap(faulty):.3e})")
    require(gap(sound) <= LOSS_REL and gap(faulty) > LOSS_REL, "the shared-verdict fault went unseen, or the sound "
                                                               "vmap differs from B=1")
    del params, grad1, per_sample, vloss
    gc.collect()
    torch.cuda.empty_cache()

    # 26 layers, staged.
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    names = [torch.utils._pytree.keystr(k) for k, _ in torch.utils._pytree.tree_flatten_with_path(params)[0]]

    def loss(p, i, t, m, c, s_):
        return _fn_loss(p, i, t, m, c, s_, cfg)

    grad = tt.grad(loss)
    per_sample = tt.vmap(grad, in_axes=axes)
    out, times, counts, mem = _three_calls(per_sample, params, idx, tgt, mask, cos, sin)
    peak = max(m[2] for m in mem)
    log(f"  (a) {_mem_line(mem)}")
    st = tt.last_staging(per_sample)
    worst = 0.0
    for s in range(V):
        want = grad(params, idx[s], tgt[s], mask[s], cos, sin)
        w_s, where_s, _ = _grad_gaps([g[s:s + 1] for g in out], [want], names)
        if w_s >= worst:
            worst, where = w_s, where_s.replace("[0]", f"[{s}]")
        del want
    log(f"  (a) {cfg.n_layer} layers, vmap(grad) staged: {', '.join(f'{x:.4f}' for x in times)} s/call (trace + "
        f"warm-up, capture, replay); staged {st.staged}; launches a call {counts[-1]}; worst gap against B=1 "
        f"{worst:.3e} on {where} (limit {GRAD_REL:.3e}); max_memory_allocated {peak / 2**30:.2f} GiB")
    require(st.staged and all(c.get("flash_fwd_seg") == c.get("flash_bwd_recompute") == cfg.n_layer for c in counts),
            "the staged masked per-sample grads are not staged or launch rows 8-9 other than once a call site")
    require(worst <= GRAD_REL, "the 26-layer masked per-sample grads differ from grad at B=1")
    for k in launches:
        launches[k] = launches.get(k, 0) + sum(c.get(k, 0) for c in counts)
    del out
    trace = tt.compile_stats(per_sample).last_traces[-1]
    prof = profile_call("masked_per_sample_staged", lambda: per_sample(params, idx, tgt, mask, cos, sin), batch=V,
                        seq=SEQ, config=CFG_NAME)
    del per_sample
    gc.collect()
    torch.cuda.empty_cache()
    fi, ft, fm = idx.reshape(V, SEQ), tgt.reshape(V, SEQ), mask.reshape(V, 1, SEQ, SEQ)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        grad(params, fi, ft, fm, cos, sin)
    torch.cuda.synchronize()
    b2_peak = torch.cuda.max_memory_allocated()
    b2 = profile_call("masked_grad_b2", lambda: grad(params, fi, ft, fm, cos, sin), batch=V, seq=SEQ, config=CFG_NAME)
    for label, pr, pk in (("vmap(grad), V=2 x (1, 2048)", prof, peak), ("grad, B=2", b2, b2_peak)):
        log(f"  (a) {label}: {min(pr['wall_ms']):.2f} ms/call, enqueue {min(pr['enqueue_ms']):.2f} ms, device "
            f"{pr['device_ms']:.2f} ms, busy {pr['busy_share']:.4f}, by group "
            f"{ {k: round(v, 3) for k, v in pr['device_ms_by_group'].items()} }, peak {pk / 2**30:.2f} GiB")
    del params, grad
    gc.collect()
    torch.cuda.empty_cache()
    return {"trace": trace, "inputs": (idx, tgt, mask, cos, sin), "staged_peak": peak}


def _distinct_norms(params: dict, seed: int) -> dict:
    """``params`` with every norm weight 1 + 0.1 N(0, 1) from ``seed``
    (``init_params`` gives them all ones), so that stacked models differ in
    them and a rule that reads one slice's weight for all is seen."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    norms = [p[k] for p in params["blocks"] for k in ("norm_1", "norm_2") if k in p] + [params["ln_f"]]
    for n in norms:
        w = n["weight"]
        n["weight"] = (1 + 0.1 * torch.randn(w.shape, generator=gen, device="cuda")).to(w.dtype)
    return params


def run_ensemble(cfg, launches: dict) -> None:
    """Phase 19 (b). Two open_llama_3b models (26 layers) stacked under
    ``+norm``, each slice with its own norm weights and its rope tables
    offset by its first position, at B=1 x T=2048 a slice: the per-slice
    rules at the path's shapes bit-equal to each model's own calls, one
    RMSNorm and one rope launch a call site, and each slice's logits
    against its model alone within ENSEMBLE_LOGITS_REL."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import batching, fusedex, normex
    from thunder_tpu_torch.models import gpt

    V = len(ENSEMBLE_OFFSETS)
    stacked = _distinct_norms(gpt.init_params(cfg, seed=SEED, device="cuda"), SEED + 30)
    other = _distinct_norms(gpt.init_params(cfg, seed=SEED + 1, device="cuda"), SEED + 31)
    stacked = torch.utils._pytree.tree_map(lambda a, b: torch.stack([a, b]), stacked, other)
    del other
    gc.collect()
    torch.cuda.empty_cache()
    tabs = [_rope_tables(cfg, SEQ, off) for off in ENSEMBLE_OFFSETS]
    cos, sin = torch.stack([c for c, _ in tabs]), torch.stack([s_ for _, s_ in tabs])
    idx = torch.from_numpy(np.random.RandomState(SEED + 20).randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    stack = NORM_STACK.split(",")

    # The rules at the path's shapes, against each model's own calls.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = torch.randn((V, SEQ, cfg.n_embd), generator=gen, device="cuda").to(torch.bfloat16)
    w = stacked["blocks"][0]["norm_1"]["weight"]
    y = torch.func.vmap(lambda a, ww: batching.norm_fwd(a, ww, None, cfg.norm_eps, False))(x, w)
    q = torch.randn((V, 1, cfg.n_head, SEQ, cfg.head_size), generator=gen, device="cuda").to(torch.bfloat16)
    r = torch.func.vmap(batching.rope)(q, cos, sin)
    require(not torch_equal(w[0], w[1]), "the ensemble's models share their norm weights")

    def same_as_alone(y, r):
        return [torch_equal(y[s], normex.rms_norm_fwd(x[s], w[s], cfg.norm_eps)) and
                torch_equal(r[s], fusedex.apply_rope(q[s], cos[s], sin[s])) for s in range(V)]

    same = same_as_alone(y, r)
    log(f"  (b) the rules at the path's shapes: RMSNorm ({SEQ}, {cfg.n_embd}) with a weight a slice and rope "
        f"(1, {cfg.n_head}, {SEQ}, {cfg.head_size}) with tables a slice, bit-equal to each model's own call {same}")
    require(all(same), "a per-slice norm or rope rule differs from the model's own kernel call")
    # The planted fault: slice 0's weight row (and tables) given to every slice.
    bad_y = torch.func.vmap(lambda a, ww: batching.norm_fwd(a, ww, None, cfg.norm_eps, False))(
        x, w[:1].expand_as(w).contiguous())
    bad_r = torch.func.vmap(batching.rope)(q, cos[:1].expand_as(cos).contiguous(), sin[:1].expand_as(sin).contiguous())
    planted = same_as_alone(bad_y, bad_r)
    log(f"  (b) planted fault (slice 0's norm weight and rope tables for every slice): bit-equal {planted}")
    require(not all(planted), "the per-slice comparison did not see slice 0's weight given to every slice")
    del x, y, q, r, bad_y, bad_r

    fwd = tt.vmap(lambda p, i, c, s_: _fn_forward(p, i, None, c, s_, cfg), in_axes=(0, 0, 0, 0), executors=stack)
    logits, n = _count_calls(fwd, stacked, idx, cos, sin)
    one = tt.jit(lambda p, i, c, s_: _fn_forward(p, i, None, c, s_, cfg), executors=stack)
    rels = []
    for s in range(V):
        ps = torch.utils._pytree.tree_map(lambda t, _s=s: t[_s], stacked)
        want = one(ps, idx[s], cos[s], sin[s])
        rels.append(((logits[s].float() - want.float()).norm() / want.float().norm()).item())
        del want, ps
    n_l = cfg.n_layer
    log(f"  (b) {n_l} layers, vmap(forward) over {V} models at offsets {ENSEMBLE_OFFSETS}: launches {n}; logits "
        f"against each model alone, norm-relative {[f'{x:.3e}' for x in rels]} (limit {ENSEMBLE_LOGITS_REL:.3e})")
    require(n.get("rms_fwd") == 2 * n_l + 1 and n.get("rope") == 2 * n_l and n.get("flash_fwd") == n_l,
            f"the ensemble's norm, rope or flash kernels are not launched once a call site: {n}")
    require(max(rels) <= ENSEMBLE_LOGITS_REL, "the ensemble's logits differ from each model alone")
    for k in launches:
        launches[k] = launches.get(k, 0) + n.get(k, 0)
    del stacked, logits, fwd, one
    gc.collect()
    torch.cuda.empty_cache()


def run_quant_per_sample(cfg, launches: dict) -> None:
    """Phase 19 (c). ``vmap(grad(loss_fn))`` under the quant stack, 26
    layers, V=2 x (1, 2048): the per-slice quantization and GEMM at the
    path's shapes bit-equal to each slice's own calls (its own scale), one
    launch of each quantization kernel and of the GEMM a call site, the
    grads against ``grad`` at B=1 within phase 18's limit."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import batching, quantex
    from thunder_tpu_torch.models import gpt

    V = PS_SAMPLES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    x = torch.stack([torch.randn((SEQ, cfg.n_embd), generator=gen, device="cuda") * (s + 1)
                     for s in range(V)]).to(torch.bfloat16)
    w = (torch.randn((3 * cfg.n_embd, cfg.n_embd), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    qx, sx = torch.func.vmap(lambda a: batching.quant_tensor(a, 127.0))(x)
    qw, sw = quantex.quantize_rows(w, 127.0)
    out = torch.func.vmap(lambda a, c: batching.int8_gemm(a, qw, c, None, torch.bfloat16))(qx, sx[:, None] * sw[:, 0])
    same = []
    for s in range(V):
        q1, s1 = quantex.quantize_tensor(x[s], 127.0)
        same.append(torch_equal(qx[s], q1) and torch_equal(sx[s], s1)
                    and torch_equal(out[s], quantex.int8_gemm(q1, qw, s1 * sw[:, 0], None, torch.bfloat16)))
    log(f"  (c) the rules at the path's shapes: activations ({SEQ}, {cfg.n_embd}) a slice, scales "
        f"{[f'{float(v):.6e}' for v in sx]}, int8 operands, scales and GEMM outputs bit-equal to each slice's own "
        f"calls {same}")
    require(all(same), "the per-slice quantization or GEMM differs from the slice's own calls")
    del x, w, qx, qw, out

    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    names = [torch.utils._pytree.keystr(k) for k, _ in torch.utils._pytree.tree_flatten_with_path(params)[0]]
    rng = np.random.RandomState(SEED + 23)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (V, 1, SEQ))).cuda()
    grad = tt.grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), executors=QUANT_STACK)
    per_sample = tt.vmap(grad, in_axes=(None, 0, 0))
    times, counts = [], []
    for _ in range(3):
        _zero_counts()
        t = time.perf_counter()
        got = per_sample(params, idx, tgt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        counts.append({k: v for k, v in _launch_counts().items() if v})
    sites = tt.compile_stats(per_sample).last_traces[-1].python().count("quant_linear(")
    worst = 0.0
    for s in range(V):
        want = grad(params, idx[s], tgt[s])
        w_s, where_s, _ = _grad_gaps([g[s:s + 1] for g in got], [want], names)
        if w_s >= worst:
            worst, where = w_s, where_s.replace("[0]", f"[{s}]")
        del want
    c = counts[-1]
    log(f"  (c) {cfg.n_layer} layers, vmap(grad) under {','.join(QUANT_STACK)}: {', '.join(f'{x:.4f}' for x in times)}"
        f" s/call; staged {tt.last_staging(per_sample).staged}; launches a call {c}; quant claims in the trace "
        f"{sites}; worst gap against B=1 {worst:.3e} on {where} (limit {GRAD_REL:.3e})")
    require(all(k.get("quantize_tensor") == k.get("quantize_rows") == k.get("int8_gemm") == sites for k in counts),
            "the quant kernels are not launched once a call site under vmap")
    require(worst <= GRAD_REL, "the quant per-sample grads differ from grad at B=1")
    for k in launches:
        launches[k] = launches.get(k, 0) + sum(cc.get(k, 0) for cc in counts)
    del params, got, grad, per_sample
    gc.collect()
    torch.cuda.empty_cache()


# =============================================================================
# Phase 20: the analysis layer on the card
# =============================================================================

LIVENESS_TOLERANCE = 0.15  # the JAX package's own (tests/test_static_planner.py:197-222)
COST_BOUND_REL = 0.01


def run_verifier(cfg) -> None:
    """Phase 20 (a). ``debug_checks=True`` on the staged 26-layer training
    step (value_and_grad at B=2) and the B=10 forward: no ERROR at any pass,
    the same loss and logits as without; first-call seconds with and without
    the checks and the verifier's ms per pass; ``examine.lint`` of the step."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import examine
    from thunder_tpu_torch.core import trace as ttrace
    from thunder_tpu_torch.models import gpt

    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 24)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    fidx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (FWD_BATCH, SEQ))).cuda()
    res = {}
    for checks in (False, True):
        ttrace.verify_seconds.clear()
        vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), debug_checks=checks)
        t = time.perf_counter()
        loss, grads = vg(params, idx, tgt)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        for _ in range(2):  # capture, replay
            loss2, _ = vg(params, idx, tgt)
        torch.cuda.synchronize()
        passes = list(ttrace.verify_seconds)
        fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg), debug_checks=checks)
        logits = fwd(params, fidx)
        torch.cuda.synchronize()
        res[checks] = (loss.clone(), loss2.clone(), first, passes, logits[:, -1].clone(), tt.last_staging(vg).staged)
        del grads, logits, fwd
        if checks:
            lint_step = vg
        else:  # free its graphs' pools before the checked compile
            del vg
            gc.collect()
            torch.cuda.empty_cache()
    (l0, r0, f0, _, z0, st0), (l1, r1, f1, p1, z1, st1) = res[False], res[True]
    log(f"  (a) {cfg.n_layer} layers: value_and_grad at B={LOSS_BATCH} (staged {st0}/{st1}) first call "
        f"{f0:.3f} s without checks, {f1:.3f} s with; the verifier ran at {len(p1)} passes, "
        f"{1e3 * sum(p1) / max(len(p1), 1):.2f} ms a pass ({1e3 * sum(p1):.1f} ms in all, with the B={FWD_BATCH} "
        f"forward's); losses {float(l0):.6f} / {float(l1):.6f} (bit-equal {torch_equal(l0, l1)}), replayed "
        f"{float(r0):.6f} / {float(r1):.6f}; B={FWD_BATCH} last-position logits bit-equal {torch_equal(z0, z1)}")
    require(torch_equal(l0, l1) and torch_equal(r0, r1) and torch_equal(z0, z1) and len(p1) >= 10,
            "the checked compile's results differ from the unchecked, or the verifier did not run")
    diags = examine.lint(lint_step, params, idx, tgt)
    counts = {}
    for d in diags:
        counts[(d.rule, str(d.severity))] = counts.get((d.rule, str(d.severity)), 0) + 1
    log(f"  (a) examine.lint of the step: {counts or 'clean'}")
    require(not any(d.severity.name == "ERROR" for d in diags), "examine.lint found an ERROR on the step")
    del params, lint_step
    gc.collect()
    torch.cuda.empty_cache()


def _measured_peak(fn, inputs) -> int:
    """``max_memory_allocated`` over one call of ``fn``, less what was
    allocated before it other than its inputs (the plan counts the inputs)."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = sum(t.untyped_storage().nbytes() for t in {id(t): t for t in inputs}.values())
    stray = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - stray
    del out
    return peak


def run_liveness(cfg, masked: dict) -> None:
    """Phase 20 (b). ``examine.memory_report``'s predicted peak against
    ``max_memory_allocated`` on the unstaged training step (B=2), the B=10
    forward and phase 19 (a)'s masked per-sample step (its trace planned
    with the batched inputs charged V times), each unstaged one held within
    LIVENESS_TOLERANCE, the staged one's gap printed (the plan has no model
    of a capture); then ``mem.predicted-oom`` on the step at B=32,
    raised from the trace before any allocation."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import analysis, examine
    from thunder_tpu_torch.analysis.liveness import claimed_trace
    from thunder_tpu_torch.models import gpt

    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    flat = torch.utils._pytree.tree_flatten(params)[0]
    rng = np.random.RandomState(SEED + 25)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    fidx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (FWD_BATCH, SEQ))).cuda()
    vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), disable_jit_staging=True)
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg), disable_jit_staging=True)
    vg(params, idx, tgt)  # compile and warm up
    fwd(params, fidx)
    rows = []
    for label, fn, args in (("train step, B=2 (unstaged)", vg, (params, idx, tgt)),
                            (f"forward, B={FWD_BATCH} (unstaged)", fwd, (params, fidx))):
        plan = examine.memory_report(fn, *args)
        measured = _measured_peak(lambda: fn(*args), flat + [a for a in args[1:]])
        rows.append((label, plan.peak_bytes, measured, plan, True))
    # Phase 19 (a)'s step: the per-slice trace, its batched inputs charged V
    # times, against the same vmap unstaged and against phase 19 (a)'s
    # staged peak.
    trc = masked["trace"]
    n_par = len(flat)
    args = [a for a in torch.utils._pytree.tree_flatten((trc.args, trc.kwargs))[0] if hasattr(a, "shape")]
    batched = {a.name for a in args[n_par:n_par + 3]}  # idx, tgt, mask: after the params, before cos and sin
    plan = analysis.plan_liveness(trc, batched=(PS_SAMPLES, batched))
    inputs = masked["inputs"]
    vf = tt.vmap(tt.grad(lambda p, i, t, m, c, s_: _fn_loss(p, i, t, m, c, s_, cfg), disable_jit_staging=True),
                 in_axes=(None, 0, 0, 0, None, None))
    vf(params, *inputs)
    rows.append((f"masked vmap(grad), V={PS_SAMPLES} (unstaged)", plan.peak_bytes,
                 _measured_peak(lambda: vf(params, *inputs), flat + list(inputs)), plan, True))
    # Not held: the plan has no model of a CUDA graph's capture (its pool,
    # static copies of the inputs); phase 19 (a) prints what each call holds.
    rows.append((f"masked vmap(grad), V={PS_SAMPLES} (staged, phase 19 (a))", plan.peak_bytes, masked["staged_peak"],
                 plan, False))
    del vf
    for label, pred, meas, plan, held in rows:
        gap = (pred - meas) / meas
        log(f"  (b) {label}: predicted peak {pred / 2**30:.3f} GiB (at L{plan.peak_index} {plan.peak_sym}), "
            f"max_memory_allocated {meas / 2**30:.3f} GiB, gap {gap:+.2%} "
            f"({'within' if abs(gap) <= LIVENESS_TOLERANCE else 'outside'} {LIVENESS_TOLERANCE:.0%}"
            f"{'' if held else '; not held to it: the capture is not planned'})")
        require(pred > 0 and meas > 0, f"{label}: no peak")
        require(not held or abs(gap) <= LIVENESS_TOLERANCE,
                f"{label}: the predicted peak is {gap:+.2%} from max_memory_allocated")
    del vg, fwd
    gc.collect()
    torch.cuda.empty_cache()

    # The step at B=32 cannot fit: the rule says so from the trace alone.
    big_idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (32, SEQ))).cuda()
    step32 = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    trc = claimed_trace(step32, (params, big_idx, big_idx), {})
    diags = analysis.verify(trc)
    plan = analysis.plan_liveness(trc, include_rows=False)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    oom = [d for d in diags if d.rule == "mem.predicted-oom"]
    log(f"  (b) train step at B=32: predicted peak {plan.peak_bytes / 2**30:.1f} GiB against "
        f"{analysis.device_capacity_bytes() / 2**30:.1f} GiB; {oom[0].format() if oom else 'no finding'}; "
        f"memory_allocated before {before} and after {after} bytes")
    require(len(oom) == 1 and before == after, "mem.predicted-oom did not fire at B=32 before any allocation")
    del params, big_idx, trc
    gc.collect()
    torch.cuda.empty_cache()


def run_cost(cfg, rows: dict) -> None:
    """Phase 20 (c). ``analysis.kernel_costs`` on the "h100" spec, for each
    kernel row's claim traced at phase 3's shapes, against the row's
    ``bound_ms`` (within COST_BOUND_REL); then ``trace_cost`` of the
    26-layer step by kind beside ``profile_gpt``'s device ms by group."""
    import os

    import torch

    import thunder_tpu_torch as tt
    import thunder_tpu_torch.clang as tclang
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch import analysis
    from thunder_tpu_torch.api import _staged_flat_fn
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.transforms.autodiff import grad_transform

    spec = analysis.resolve_device_spec("h100")
    bf = torch.bfloat16
    B, H, D, N, V = LOSS_BATCH, cfg.n_head, cfg.head_size, LOSS_BATCH * SEQ, cfg.padded_vocab_size
    cpu = dict(device="cpu")

    def claims(fn, args, executors, grad=False):
        transforms = (lambda trc: grad_transform(trc, return_value=True),) if grad else ()
        trc, _ = _staged_flat_fn(fn, args, {}, executors=resolve_executors(executors), trace_transforms=transforms)
        return trc.bound_symbols

    def kernel(bsyms, sym, name=None, **kw):
        b = next(b for b in bsyms if b.sym.name == sym)
        parts = analysis.kernel_costs(b, **kw)
        return next(c for n_, c in parts if name is None or n_ == name)

    q = torch.zeros((B, H, SEQ, D), dtype=bf, **cpu)
    cs = torch.zeros((SEQ, D), dtype=bf, **cpu)
    attn = lambda a, b_, c: ttorch.sum(ttorch.scaled_dot_product_attention(a, b_, c, is_causal=True).float())  # noqa
    sd = claims(attn, (q, q, q), ["flash", "torch"])
    sdg = claims(attn, (q, q, q), ["flash", "torch"], grad=True)
    rope = claims(lambda x, c, s_: ttorch.apply_rope(x, c, s_), (q, cs, cs), ["fused", "torch"])
    logits = torch.zeros((N, V), **cpu)
    tg = torch.zeros((N,), dtype=torch.int64, **cpu)
    ce = claims(lambda x, t: ttorch.cross_entropy(x, t), (logits, tg), ["fused", "torch"], grad=True)
    costs = {"flash_fwd": kernel(sd, "scaled_dot_product_attention"), "flash_fwd_lse": kernel(sdg, "sdpa_fwd_res"),
             "flash_bwd": kernel(sdg, "sdpa_bwd_res"), "rope": kernel(rope, "apply_rope"),
             "rope_bwd": kernel(rope, "apply_rope"), "ce_fwd": kernel(ce, "cross_entropy"),
             "ce_bwd": kernel(ce, "cross_entropy_bwd")}
    del logits
    pythia = gpt.name_to_config(PYTHIA)
    for tag, (n_, d_, ln) in {"rms": (N, cfg.n_embd, False), "ln": (N, pythia.n_embd, True)}.items():
        x = torch.zeros((n_, d_), dtype=bf, **cpu)
        w = torch.zeros((d_,), dtype=bf, **cpu)
        f = ((lambda a, ww, bb: ttorch.sum(ttorch.layer_norm(a, (d_,), ww, bb, 1e-5).float())) if ln else
             (lambda a, ww: ttorch.sum(ttorch.rms_norm(a, (d_,), ww, 1e-6).float())))
        bs = claims(f, (x, w, w) if ln else (x, w), ["norm", "torch"], grad=True)
        costs[f"{tag}_fwd"] = kernel(bs, "layer_norm" if ln else "rms_norm")
        costs[f"{tag}_bwd"] = kernel(bs, "layer_norm_bwd" if ln else "rms_norm_bwd")
    label, Tq, padding, causal = MASK_CASES[0]
    q_seg, kv_seg = _segments(B, Tq, SEQ, padding, causal)
    pairs = _valid_pairs(q_seg, kv_seg, causal)
    m = torch.zeros((B, 1, Tq, SEQ), dtype=torch.bool, **cpu)
    masked = claims(lambda a, b_, c, mm: ttorch.sum(ttorch.scaled_dot_product_attention(a, b_, c, attn_mask=mm)
                                                    .float()), (q, q, q, m), ["flash", "torch"], grad=True)
    costs["flash_fwd_seg"] = kernel(masked, "scaled_dot_product_attention", valid_pairs=pairs)
    costs["flash_bwd_recompute"] = kernel(masked, "sdpa_bwd", valid_pairs=pairs)
    os.environ["THUNDER_FLASH_IMPL"] = "legacy"
    try:
        leg = claims(attn, (q, q, q), ["flash", "torch"], grad=True)
    finally:
        del os.environ["THUNDER_FLASH_IMPL"]
    costs["legacy_fwd"] = kernel(leg, "scaled_dot_product_attention")
    costs["legacy_bwd"] = kernel(leg, "sdpa_bwd")
    draw = claims(lambda: tclang.uniform((B, SEQ, cfg.n_embd), 0.0, 1.0, device=tt.devices.Device("cpu"), dtype=tt.dtypes.bfloat16), (), ["torch"])
    costs["rng_draw"] = kernel(draw, "uniform_keyed")
    _, n_, k_ = INT8_SHAPES[0]
    a = torch.zeros((N, k_), dtype=bf, **cpu)
    qb = claims(lambda x, w: ttorch.linear(x, w), (a, torch.zeros((n_, k_), dtype=bf, **cpu)), ["quant", "torch"])
    costs["int8_gemm"] = kernel(qb, "linear", "int8_gemm")
    shape = QUANT_ACTS[0]
    qa = claims(lambda x, w: ttorch.linear(x, w), (torch.zeros(shape, dtype=bf, **cpu),
                                                    torch.zeros((64, shape[-1]), dtype=bf, **cpu)), ["quant", "torch"])
    costs["quantize_tensor"] = kernel(qa, "linear", "quantize_tensor")
    wshape = QUANT_WEIGHTS[0]
    qr = claims(lambda x, w: ttorch.linear(x, w), (torch.zeros((64, wshape[-1]), dtype=bf, **cpu),
                                                    torch.zeros(wshape, dtype=bf, **cpu)), ["quant", "torch"])
    costs["quantize_rows"] = kernel(qr, "linear", "quantize_rows")
    worst = 0.0
    for name, row in rows.items():
        c = costs.get(name)
        require(c is not None, f"no cost rule reproduces kernel row {name}")
        ms_, by = c.seconds(spec)
        rel = abs(ms_ * 1e3 - row["bound_ms"]) / row["bound_ms"]
        worst = max(worst, rel)
        log(f"  (c) {name:20s} cost.py {ms_ * 1e3:.4f} ms ({by}) vs the row's bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}): {rel:.3%}")
    require(worst <= COST_BOUND_REL and len(costs) == len(rows) == 19,
            f"cost.py does not reproduce every kernel row's bound within {COST_BOUND_REL:.0%} (worst {worst:.3%})")

    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 26)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    prof = profile_call("step_for_cost", lambda: vg(params, idx, idx), batch=LOSS_BATCH, seq=SEQ, config=CFG_NAME)
    tc = analysis.trace_cost(tt.last_traces(vg)[-1], spec)
    kinds = {k: round(v["roofline_s"] * 1e3, 3) for k, v in sorted(tc.by_kind().items(),
                                                                    key=lambda kv: -kv[1]["roofline_s"])}
    log(f"  (c) the staged step at B={LOSS_BATCH}: trace_cost bound {tc.roofline_s * 1e3:.2f} ms by kind {kinds}; "
        f"measured device {prof['device_ms']:.2f} ms by group "
        f"{ {k: round(v, 3) for k, v in prof['device_ms_by_group'].items()} }")
    del params, vg
    gc.collect()
    torch.cuda.empty_cache()


# =============================================================================
# Phase 21: the observability layer
# =============================================================================

HIT_SAMPLES = 240  # fast hits timed with metrics off, and as many on, in turns
# One hit each way a turn: on the H100 machine the host's speed drifted by
# more than the limit between blocks of 20 hits (a run of 12 such blocks
# read 1.0645x, each side's p10-p90 spanning ±25%); a drift shared by the
# two hits of a turn cancels in the medians.
HIT_ROUNDS = HIT_SAMPLES
METRICS_OVERHEAD = 1.05  # the median hit with metrics on against off
OPTIMER_BAND = (1.0, 2.0)  # a kernel line's OpTimer time over its phase 3 row's
MEMORY_REL = 0.02  # MemoryHighWater's peak against max_memory_allocated
ATTRIBUTED_SHARE = 0.95
STEP_TOTAL_REL = 0.03  # the attributed ms a step against profile_call's device ms
GROUP_REL = 0.01  # a kernel group's lines against profile_call's group
ROOFLINE_STEP_REL = 0.01
ROOFLINE_EVERY = 2
ROOFLINE_STEPS = 6

# The kernel lines of the staged step: the claim's symbol, its trace (the
# pass tag prefix), the phase 3 row with its bound, profile_gpt's group.
KERNEL_LINES = (("sdpa_fwd_res", "augmented_forward", "flash_fwd_lse", "flash_fwd"),
                ("sdpa_bwd_res", "backward", "flash_bwd", "flash_bwd"),
                ("apply_rope", "augmented_forward", "rope", "rope"),
                ("apply_rope", "backward", "rope_bwd", "rope"),
                ("cross_entropy", "augmented_forward", "ce_fwd", "ce"),
                ("cross_entropy_bwd", "backward", "ce_bwd", "ce"))


def _median(xs: list) -> float:
    return float(np.median(np.asarray(xs)))


def run_events(cfg) -> None:
    """Phase 21 (a). The 26-layer staged loss and training step (``jit`` and
    ``value_and_grad``) under ``jit(events=<path>)`` with metrics on, three
    calls each (warm-up, capture, replay): the log replayed by
    ``analysis.events`` (no ERROR; each ``compile_start`` closed; a ``pass``
    event with its ms for every timed pass of each entry's traces), the
    report's cache lines beside ``cache_info``; then the host µs of a fast
    hit of the staged loss with metrics off and on, HIT_SAMPLES each in
    HIT_ROUNDS turns, the medians held within METRICS_OVERHEAD."""
    import tempfile

    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.analysis import events as ev_replay
    from thunder_tpu_torch.models import gpt

    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 27)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    logdir = tempfile.mkdtemp(prefix="chip_smoke_events_")
    log_path = f"{logdir}/events.jsonl"
    monitor.reset()
    monitor.enable()
    try:
        loss_fn = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), events=log_path)
        step_fn = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), events=log_path)
        for _ in range(3):
            loss_fn(params, idx, tgt)
        out = None
        for _ in range(3):
            out = step_fn(params, idx, tgt)
        torch.cuda.synchronize()
        del out
        report = monitor.report()
    finally:
        monitor.disable()
    summary, diags = ev_replay.replay_events(log_path)
    log("  (a) " + ev_replay.format_replay(summary, diags).replace("\n", "\n  (a) "))
    require(not any(d.severity.name == "ERROR" for d in diags), "the event replay found an ERROR")
    require(summary["kinds"].get("compile_start") == summary["kinds"].get("compile_end") == 2
            and not any(d.rule == "events.unclosed-compile" for d in diags),
            "compile_start/compile_end do not pair up")
    records = [json.loads(line) for line in open(log_path) if line.strip()]
    missing = []
    for fn in (loss_fn, step_fn):
        cs = tt.compile_stats(fn)
        entry = cs.cache_entries[-1]
        passes = [r for r in records if r["kind"] == "pass" and r["compile_id"] == entry.compile_id]
        for trc in entry.computation_traces + entry.prologue_traces:
            if trc.provenance is None or "(took" not in trc.provenance.pss:
                continue
            if not any(r["name"] == trc.pass_name() and r["trace"] == trc.name and r["ms"] is not None
                       and r["n_bsyms"] == len(trc.bound_symbols) for r in passes):
                missing.append(f"compile {entry.compile_id}: {trc.pass_name()} of {trc.name}")
        phases = [r["phase"] for r in records if r["kind"] == "compile_phase" and r["compile_id"] == entry.compile_id]
        log(f"  (a) compile {entry.compile_id}: {len(passes)} pass events "
            f"({sum(r['ms'] is not None for r in passes)} timed), phases {phases}")
        require(phases == ["trace", "transforms", "claim", "warmup", "capture", "hlo_audit"],
                f"compile {entry.compile_id}'s phases are {phases}")
    require(not missing, f"no pass event with ms for {missing}")
    hits = report["thunder_tpu_cache_hits_total"]["values"]
    infos = [tt.cache_info(f) for f in (loss_fn, step_fn)]
    want = {"fast": sum(i["fast_hits"] for i in infos), "slow": sum(i["slow_hits"] for i in infos)}
    got = {k: hits.get(f'{{kind="{k}"}}', 0) for k in want}
    misses = report["thunder_tpu_cache_misses_total"]["values"].get("", 0)
    log(f"  (a) monitor.report(): cache hits by kind {got}, misses {misses}; cache_info: fast_hits+slow_hits "
        f"{want}, misses {sum(i['misses'] for i in infos)}, calls {sum(i['calls'] for i in infos)}")
    require(got == want and misses == sum(i["misses"] for i in infos), "the report's cache lines differ from cache_info")

    # A fast hit's host µs, metrics off and on in turns.
    def hit_us() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss_fn(params, idx, tgt)
        dt = (time.perf_counter() - t) * 1e6
        torch.cuda.synchronize()
        return dt

    per = HIT_SAMPLES // HIT_ROUNDS
    off, on = [], []
    try:
        for _ in range(HIT_ROUNDS):
            monitor.disable()
            off += [hit_us() for _ in range(per)]
            monitor.enable()
            on += [hit_us() for _ in range(per)]
    finally:
        monitor.disable()
        monitor.reset()
    m_off, m_on = _median(off), _median(on)
    log(f"  (a) fast hit of the staged loss, host µs to return (replay enqueued): metrics off median {m_off:.1f} "
        f"(p10 {np.percentile(off, 10):.1f}, p90 {np.percentile(off, 90):.1f}), on median {m_on:.1f} "
        f"(p10 {np.percentile(on, 10):.1f}, p90 {np.percentile(on, 90):.1f}) over {len(off)} hits each: "
        f"{m_on / m_off:.4f}x")
    require(len(off) >= 200 and m_on <= METRICS_OVERHEAD * m_off,
            f"metrics on cost {m_on / m_off:.4f}x a fast hit (limit {METRICS_OVERHEAD}x)")
    del params, loss_fn, step_fn
    gc.collect()
    torch.cuda.empty_cache()


def run_instrument(cfg, rows: dict) -> None:
    """Phase 21 (b), 2 layers at full width: ``debug_watch="nan"`` with a
    planted +inf and -inf in one row of layer 1's ``fc_1_w`` (a NaN where
    the two products meet with one sign) raises ``NaNWatchError`` at the op
    that a per-op callback finds first to make a non-finite value; the same
    loss unplanted, instrumented, bit-equal to the unstaged call's;
    ``instrument="time"``'s flash, rope and CE lines against phase 3's rows;
    ``instrument="memory"``'s peak against ``max_memory_allocated``."""
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability.instrument import (CallbackHook, MemoryHighWater, NaNWatchError,
                                                            instrument_reports)

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 28)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    loss = lambda p, i, t: gpt.loss_fn(p, i, t, cfg2)  # noqa: E731

    planted = {**params, "blocks": list(params["blocks"])}
    mlp = dict(planted["blocks"][1]["mlp"])
    w = mlp["fc_1_w"].clone()
    w[0, 0], w[0, 1] = float("inf"), float("-inf")
    mlp["fc_1_w"] = w
    planted["blocks"][1] = {**planted["blocks"][1], "mlp": mlp}
    flags = []
    probe = tt.jit(loss, instrument=CallbackHook(lambda rec, outs: flags.append(
        (rec.index, rec.sym_name, any(isinstance(x, torch.Tensor) and x.is_floating_point()
                                      and not bool(torch.isfinite(x).all()) for x in outs)))))
    probe(planted, idx, tgt)
    first = next((i, s) for i, s, bad in flags if bad)
    watched = tt.jit(loss, debug_watch="nan")
    try:
        watched(planted, idx, tgt)
        raised = None
    except NaNWatchError as e:
        raised = e
    log(f"  (b) debug_watch='nan', +inf/-inf planted in layer 1's fc_1_w: "
        + (f"NaNWatchError at bsym {raised.bsym_index} {raised.sym_name!r} `{raised.trace_line}` "
           f"(pass {raised.provenance}); the first op with a non-finite output (a per-op callback): bsym "
           f"{first[0]} {first[1]!r}" if raised else "no error"))
    require(raised is not None and (raised.bsym_index, raised.sym_name) == first,
            "the NaN watch did not stop at the first op that made a non-finite value")
    del planted, mlp, w, probe, watched

    eager = tt.jit(loss, disable_jit_staging=True)
    want = eager(params, idx, tgt)
    clean = tt.jit(loss, debug_watch="nan")
    got = clean(params, idx, tgt)
    log(f"  (b) unplanted: instrumented loss {float(got):.6f} (staged {tt.last_staging(clean).staged}, "
        f"{tt.last_staging(clean).reason!r}), unstaged {float(want):.6f}, bit-equal {torch_equal(got, want)}, "
        f"on {got.device}")
    require(torch_equal(got, want) and got.is_cuda, "the instrumented loss differs from the unstaged call's")

    timed = tt.jit(loss, instrument="time")
    for _ in range(3):
        timed(params, idx, tgt)
    rep = instrument_reports(timed)[0]
    ops = {o["symbol"]: o for o in rep["ops"]}
    top = ", ".join(f"{o['symbol']} {o['total_s'] / o['calls'] * 1e3:.4f} ms x{o['calls'] // 3}"
                    for o in rep["ops"][:8])
    log(f"  (b) instrument='time': {rep['total_s'] / 3 * 1e3:.2f} ms of op time a call, {rep['host_gaps']} ops whose "
        f"launches outran the sleep; top: {top}")
    for sym, row in (("scaled_dot_product_attention", "flash_fwd"), ("apply_rope", "rope"),
                     ("cross_entropy", "ce_fwd")):
        o = ops[sym]
        per = o["total_s"] / o["calls"] * 1e3
        ratio = per / rows[row]["ms"]
        log(f"  (b) OpTimer {sym}: {per:.4f} ms a call ({o['calls']} calls) against phase 3's {row} "
            f"{rows[row]['ms']:.4f} ms: {ratio:.3f}x")
        require(OPTIMER_BAND[0] <= ratio <= OPTIMER_BAND[1],
                f"OpTimer's {sym} is {ratio:.3f}x phase 3's {row} row (band {OPTIMER_BAND})")
    del timed

    hw = MemoryHighWater()
    mem = tt.jit(loss, instrument=hw)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem(params, idx, tgt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rel = abs(hw.peak_bytes - peak) / peak
    log(f"  (b) instrument='memory': peak {hw.peak_bytes / 2**30:.4f} GiB at {hw.peak_op!r} (exact {hw.exact}), "
        f"max_memory_allocated over the call {peak / 2**30:.4f} GiB: {rel:.3%}")
    require(hw.exact and rel <= MEMORY_REL, f"MemoryHighWater's peak is {rel:.3%} from max_memory_allocated")
    del params, mem, eager, clean, got, want
    gc.collect()
    torch.cuda.empty_cache()


def run_attribution(cfg, rows: dict, launches: dict):
    """Phase 21 (c). The 26-layer ``build_train`` step, built under
    ``THUNDER_ANNOTATE_TRACES=1`` and staged, profiled over 3 steps
    (``thunder_tpu_torch.profile``), its graph's kernels placed through the
    launch-order map of one annotated eager step (``scope_map_of``) and
    joined with ``cost.py``'s ``h100`` spec: the attributed share (at least
    ATTRIBUTED_SHARE; the per-step total within STEP_TOTAL_REL of
    ``profile_call``'s, the mean of a call before and one after), the top 10
    lines, the kernel lines against their groups in the profiled window
    (within GROUP_REL, with the wrappers' launches), printed beside
    ``profile_call``'s groups, and against phase 20 (c)'s bounds, "other"
    split by line. Returns the Train for (d)."""
    import os

    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.benchmarks import train
    from thunder_tpu_torch.benchmarks.profile_gpt import _group, profile_call
    from thunder_tpu_torch.observability.attribution import scope_map_of

    os.environ["THUNDER_ANNOTATE_TRACES"] = "1"
    try:
        tr = train.build_train(cfg, LOSS_BATCH, SEQ, device="cuda", seed=SEED)
    finally:
        del os.environ["THUNDER_ANNOTATE_TRACES"]
    for _ in range(2):  # warm-up, capture
        tr.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lmap = scope_map_of(tr.step_eager)
    map_s = time.perf_counter() - t
    # profile_call's device ms by group before and after the attributed
    # profile, their mean the yardstick: the card's clock drifts by a few
    # tenths of a percent between two windows a few seconds apart.
    before = profile_call("train_step_before", tr.step, batch=LOSS_BATCH, seq=SEQ)
    _zero_counts()
    res = tt.profile(tr.step, steps=3, warmup=0, launch_map=lmap)
    counts = _launch_counts()
    after = profile_call("train_step_after", tr.step, batch=LOSS_BATCH, seq=SEQ)
    join = monitor.attribution_report(res["trace_dir"], traces=[tr.fw_trace, tr.bw_trace], device="h100", steps=3,
                                      launch_map=lmap)
    attr = join.attribution
    groups = set(before["device_ms_by_group"]) | set(after["device_ms_by_group"])
    prof = {"device_ms": (before["device_ms"] + after["device_ms"]) / 2,
            "device_ms_by_group": {g: (before["device_ms_by_group"].get(g, 0.0)
                                       + after["device_ms_by_group"].get(g, 0.0)) / 2 for g in groups}}
    step_ms = attr.attributed_us / 3 / 1e3
    log(f"  (c) launch-order map: {len(lmap)} device ops of one eager step, {sum(s is not None for _, s in lmap)} "
        f"in a line's range ({map_s:.2f} s); profile: {res['avg_s'] * 1e3:.2f} ms/step wall, graph kernels "
        f"{attr.graph_placed} of {attr.graph_ops} placed, by step {attr.graph_steps}, "
        f"{attr.graph_mismatched} step(s) differing from the map")
    log(f"  (c) attributed {attr.coverage:.2%} of {attr.device_busy_us / 3e3:.2f} device ms a step to "
        f"{len(attr.by_line)} lines: {step_ms:.2f} ms a step, profile_call's device ms {prof['device_ms']:.2f} "
        f"(before {before['device_ms']:.2f}, after {after['device_ms']:.2f}; "
        f"{(step_ms - prof['device_ms']) / prof['device_ms']:+.2%}); unattributed: "
        + ", ".join(f"{n[:50]} {us / 3e3:.3f} ms" for n, us in sorted(attr.unattributed.items(),
                                                                      key=lambda kv: -kv[1])[:4]))
    require(attr.coverage >= ATTRIBUTED_SHARE, f"only {attr.coverage:.2%} of the step's device time is attributed")
    require(abs(step_ms - prof["device_ms"]) <= STEP_TOTAL_REL * prof["device_ms"],
            "the attributed ms a step is not within 3% of profile_call's device ms")
    log("  (c) top 10 lines (ms a step and device ops a step, predicted bound ms, bound over measured), on "
        "cost.py's h100 spec:")
    for r in join.rows[:10]:
        roof = "-" if r.roofline_us is None else f"{r.roofline_us / 1e3:.4f}"
        eff = "-" if r.efficiency is None else f"{r.efficiency:.1%}"
        log(f"  (c)   {r.label:60s} {r.sym:22s} {r.measured_us / 1e3:9.4f} ms x{r.calls:g}  bound {roof}  {eff}")

    # The kernel lines against their groups (profile_gpt._group over every
    # kernel of the same profiled window, so that a kernel the map left
    # unattributed or put on another line shows), printed beside
    # profile_call's groups, whose windows differ from this one by the
    # card's clock (PERF.md); and against phase 20 (c)'s bounds.
    by_group: dict = {}
    group_n: dict = {}
    window: dict = {}
    for (ref, name), (us, n) in attr.ops.items():
        g = _group(name)
        window[g] = window.get(g, 0.0) + us / 3e3
        if ref is not None and g != "other":
            key = (g, ref.sym)
            by_group[key] = by_group.get(key, 0.0) + us / 3e3
            group_n[key] = group_n.get(key, 0) + n / 3
    claimed = {"flash_fwd_lse": counts["flash_fwd_lse"] / 3, "flash_bwd": counts["flash_bwd"] / 3,
               "rope": counts["rope"] / 3, "ce": (counts["ce_fwd"] + counts["ce_bwd"]) / 3}
    for g, syms in (("flash_fwd", ("sdpa_fwd_res",)), ("flash_bwd", ("sdpa_bwd_res",)), ("rope", ("apply_rope",)),
                    ("ce", ("cross_entropy", "cross_entropy_bwd"))):
        lines_ms = sum(v for (gg, s), v in by_group.items() if gg == g and s in syms)
        stray = {s: v for (gg, s), v in by_group.items() if gg == g and s not in syms}
        n = sum(v for (gg, s), v in group_n.items() if gg == g and s in syms)
        want_ms = window[g]
        call_ms = prof["device_ms_by_group"].get(g, 0.0)
        line_totals = sum(attr.by_line[ref] for ref in attr.by_line if ref.sym in syms) / 3e3
        log(f"  (c) {g}: its kernels on the {'/'.join(syms)} lines {lines_ms:.4f} ms a step ({n:g} launches; the "
            f"wrappers counted {claimed['flash_fwd_lse' if g == 'flash_fwd' else g]:g}), those lines in all "
            f"{line_totals:.4f} ms; the group in the window {want_ms:.4f} ms ({(lines_ms - want_ms) / want_ms:+.3%}), "
            f"profile_call's {call_ms:.4f} ms ({(lines_ms - call_ms) / call_ms:+.3%})"
            + (f"; elsewhere {stray}" if stray else ""))
        require(not stray and abs(lines_ms - want_ms) <= GROUP_REL * want_ms,
                f"the {g} kernels' lines do not sum to their group within {GROUP_REL:.0%}")
    require(group_n.get(("flash_fwd", "sdpa_fwd_res")) == claimed["flash_fwd_lse"]
            and group_n.get(("rope", "apply_rope")) == claimed["rope"]
            and sum(v for (g, s), v in group_n.items() if g == "ce") == claimed["ce"],
            "the kernel lines' launches differ from the wrappers' counts")
    for sym, trace_name, row, _ in KERNEL_LINES:
        rws = [r for r in join.rows if r.sym == sym and (r.pass_name or "").startswith(trace_name)]
        bounds = {round(r.roofline_us / 1e3, 6) for r in rws if r.roofline_us is not None}
        rel = max((abs(b - rows[row]["bound_ms"]) / rows[row]["bound_ms"] for b in bounds), default=1.0)
        log(f"  (c) {sym} in the {trace_name}: {len(rws)} lines, joined bound {sorted(bounds)} ms against "
            f"phase 20 (c)'s {row} {rows[row]['bound_ms']:.4f} ms ({rel:.3%}); measured "
            f"{sum(r.measured_us for r in rws) / 1e3:.4f} ms a step")
        require(rws and rel <= COST_BOUND_REL, f"{sym}'s joined bound differs from the {row} row's")

    # "other" by line: each line's ops outside the kernel groups and matmul.
    other: dict = {}
    for (ref, name), (us, n) in attr.ops.items():
        if _group(name) == "other":
            key = ref.label if ref is not None else "unattributed"
            other[key] = other.get(key, 0.0) + us / 3e3
    total_other = sum(other.values())
    bound_of = {r.label: r for r in join.rows}
    by_sym: dict = {}
    for label, ms in other.items():
        r = bound_of.get(label)
        sym = r.sym if r is not None else label
        agg = by_sym.setdefault(sym, [0.0, 0.0, 0])
        agg[0] += ms
        # A line's bound counts where all its time is "other" (not a
        # product's line that also launched a small elementwise kernel).
        if r is not None and r.roofline_us is not None and abs(r.measured_us / 1e3 - ms) <= 1e-9 + 1e-6 * ms:
            agg[1] += r.roofline_us / 1e3
        agg[2] += 1
    log(f"  (c) 'other' {total_other:.2f} ms a step (profile_call's {prof['device_ms_by_group'].get('other', 0.0):.2f})"
        f" over {len(other)} lines; by symbol (ms a step, the bound of its lines that are all 'other', lines): "
        + ", ".join(f"{s} {v[0]:.2f}/{v[1]:.2f}/{v[2]}"
                    for s, v in sorted(by_sym.items(), key=lambda kv: -kv[1][0])[:14]))
    for label, ms in sorted(other.items(), key=lambda kv: -kv[1])[:15]:
        r = bound_of.get(label)
        roof = "-" if r is None or r.roofline_us is None else f"{r.roofline_us / 1e3:.4f}"
        log(f"  (c)   other {label:60s} {ms:8.4f} ms, bound {roof} ms")
    sgd = next((r for r in join.rows if r.sym == "sgd_update"), None)
    param_bytes = sum(p.numel() * p.element_size() for p in tr.flat_params)
    log(f"  (c) the SGD update: {0.0 if sgd is None else sgd.measured_us / 1e3:.4f} ms a step; its bound "
        f"(each param read and written once, each grad read once, at {PEAK_BYTES / 1e12:.2f} TB/s) "
        f"{3 * param_bytes / PEAK_BYTES * 1e3:.4f} ms")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    return tr


def run_roofline(tr, launches: dict) -> None:
    """Phase 21 (d). The roofline sampler, every ROOFLINE_EVERY steps over
    ROOFLINE_STEPS staged steps of (c)'s Train: exactly
    ROOFLINE_STEPS / ROOFLINE_EVERY probes, a ledger row for every kernel
    line, no recapture; the mean s/step of the steps between probes within
    ROOFLINE_STEP_REL of unsampled staged steps."""
    import torch

    from thunder_tpu_torch import monitor

    from thunder_tpu_torch.observability.roofline import RooflineLedger

    captures = tr.staging.captures
    _zero_counts()
    # The ledger keeps the costliest lines up to its bound: room for every
    # line of the step, so that no kernel line is evicted by cheaper ones.
    sampler = monitor.roofline(every=ROOFLINE_EVERY, traces=[tr.fw_trace, tr.bw_trace], eager=tr.step_eager,
                               device="h100", ledger=RooflineLedger(max_ops=8192))
    between = []
    try:
        for step in range(ROOFLINE_STEPS):
            probe = (step + 1) % ROOFLINE_EVERY == 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            sampler.maybe_sample(tr.step)
            torch.cuda.synchronize()
            if not probe:
                between.append(time.perf_counter() - t)
        plain = []
        for _ in range(len(between)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.step()
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t)
        log("  (d) " + monitor.roofline_report(12).replace("\n", "\n  (d) "))
    finally:
        monitor.shutdown_roofline()
    rows = sampler.ledger.rows()
    labels = {e.label for e in rows}
    # Every kernel line of the claimed traces, as its scope names it.
    kernel_lines = {f"L{i}.{b.sym.name}#{trc._annotate_tag()}" for trc in (tr.fw_trace, tr.bw_trace)
                    for i, b in enumerate(trc.bound_symbols) if b.sym.name in {k[0] for k in KERNEL_LINES}}
    m_between, m_plain = float(np.mean(between)), float(np.mean(plain))
    log(f"  (d) every={ROOFLINE_EVERY} over {ROOFLINE_STEPS} staged steps: {sampler.probes} probes, ledger "
        f"{len(rows)} rows ({len(kernel_lines)} kernel lines, all in the ledger {kernel_lines <= labels}), "
        f"captures {captures} -> {tr.staging.captures}; steps between probes "
        f"{', '.join(f'{x:.4f}' for x in between)} s (mean {m_between:.4f}), unsampled "
        f"{', '.join(f'{x:.4f}' for x in plain)} s (mean {m_plain:.4f}): {(m_between - m_plain) / m_plain:+.3%}")
    require(sampler.probes == ROOFLINE_STEPS // ROOFLINE_EVERY, f"{sampler.probes} probes ran")
    require(kernel_lines and kernel_lines <= labels, "a kernel line has no ledger row")
    require(tr.staging.captures == captures, "the sampled steps recaptured the graph")
    require(abs(m_between - m_plain) <= ROOFLINE_STEP_REL * m_plain,
            "the steps between probes are not within 1% of the unsampled staged step")
    for k, v in _launch_counts().items():
        launches[k] = launches.get(k, 0) + v


def run_targets() -> None:
    """Phase 21 (e). ``benchmarks.targets.run_target`` for ``sdpa`` and the
    Llama block's train unit under ``kernels`` and ``torch``."""
    import torch

    from thunder_tpu_torch.benchmarks import targets

    for unit in ("sdpa", "llama_block_train"):
        for executor in ("kernels", "torch"):
            s = targets.run_target(unit, executor, iters=10)
            log(f"  (e) {json.dumps(s)}")
            require(s.get("average_iter_time_s", 0) > 0, f"target {unit}[{executor}] printed no time")
            gc.collect()
            torch.cuda.empty_cache()


# =============================================================================
# Phase 22: distribution on torch.distributed (an NCCL group of one rank)
# =============================================================================

DIST_MODES = ("ddp", "zero2", "zero3")


def dist_init() -> dict:
    """The process group of phase 22: NCCL, one rank, on this card, at a
    free localhost port (the environment torchrun would give)."""
    import os
    import socket

    import thunder_tpu_torch.distributed as td

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    info = td.init()
    import torch.distributed as tdist

    log(f"  process group: {info}, backend {tdist.get_backend()}, NCCL {torch.cuda.nccl.version()}")
    require(tdist.get_backend() == "nccl" and info["num_processes"] == 1, "phase 22's group is not one NCCL rank")
    return info


def run_dist_prims() -> None:
    """Phase 22 (a). Each collective prim staged (warm-up, capture,
    replays), on CUDA tensors at the path's shapes, against its one-rank
    value, with its own count of collective calls held to what it issues at
    one rank: a CUDA graph holding one NCCL call for all_reduce, all_gather,
    reduce_scatter, broadcast, the async gather and all_to_all; no
    collective for synchronize, hier_all_reduce, ppermute and mask_to_rank,
    which are the identity, a copy or a local op there. Then the NCCL device
    work the profiler saw."""
    import os
    import tempfile

    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
    from thunder_tpu_torch.observability.attribution import _device_ops, _without_lead_in, load_trace_events
    from thunder_tpu_torch.observability.profile import traced

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    grad = torch.randn((OPEN_LLAMA_3B.hidden_size, OPEN_LLAMA_3B.intermediate_size), generator=gen,
                       device="cuda").to(torch.bfloat16)
    emb = torch.randn((OPEN_LLAMA_3B.vocab_size, OPEN_LLAMA_3B.hidden_size), generator=gen,
                      device="cuda").to(torch.bfloat16)
    # Each case: (program, input, its one-rank value). At one rank
    # synchronize (fsdp or replicated) and hier_all_reduce are the identity
    # and call no collective, ppermute's one pair (0, 0) is a copy, and
    # mask_to_rank is local at any group size: calls_of lists the others.
    cases = {
        "all_reduce": (lambda a: dist.all_reduce(a, "dp", 1), grad, lambda a: a),
        "all_reduce avg": (lambda a: dist.all_reduce(a, "dp", 1, op="avg"), grad, lambda a: a / 1),
        "all_gather": (lambda a: dist.all_gather(a, "dp", 1), emb, lambda a: a),
        "all_gather dim 1": (lambda a: dist.all_gather(a, "dp", 1, dim=1), emb, lambda a: a),
        "reduce_scatter": (lambda a: dist.reduce_scatter(a, "dp", 1), emb, lambda a: a),
        "broadcast": (lambda a: dist.broadcast(a, "dp", 1), grad, lambda a: a),
        "synchronize fsdp": (lambda a: dist.synchronize(a, "dp", 1, "fsdp"), emb, lambda a: a),
        "synchronize replicated": (lambda a: dist.synchronize(a, "dp", 1, "replicated"), grad, lambda a: a),
        "async all_gather + wait": (lambda a: dist.wait(dist.all_gather(a, "dp", 1, async_op=True)), emb,
                                    lambda a: a),
        "ppermute": (lambda a: dist.ppermute(a, "dp", [(0, 0)]), grad, lambda a: a),
        "all_to_all": (lambda a: dist.all_to_all(a, "dp", 1, split_dim=1, concat_dim=0), grad, lambda a: a),
        "mask_to_rank": (lambda a: dist.mask_to_rank(a, "dp", 0), grad, lambda a: a),
        "hier_all_reduce": (lambda a: dist.hier_all_reduce(a, "dp", "dp", 1, 1), grad, lambda a: a),
    }
    calls_of = {"all_reduce": {"all_reduce": 1}, "all_reduce avg": {"all_reduce": 1}, "all_gather": {"all_gather": 1},
                "all_gather dim 1": {"all_gather": 1}, "reduce_scatter": {"reduce_scatter": 1},
                "broadcast": {"broadcast": 1}, "async all_gather + wait": {"all_gather": 1},
                "all_to_all": {"all_to_all": 1}}
    calls0 = dist.collective_launches()
    no_collective = []
    for label, (fn, x, want_fn) in cases.items():
        before = dist.collective_launches()
        jf, extrace = compile_with_collectives(fn, (x,), None, (P(),), P())
        want = want_fn(x)
        outs = [jf(x) for _ in range(3)]  # warm-up, capture and replay, replay
        torch.cuda.synchronize()
        st = jf.staging
        same = all(torch.equal(o, want) for o in outs)
        # The warm-up and the capture each call the program's collectives
        # once, and a replay adds its capture's: 3 runs in all.
        got = {k: v - before[k] for k, v in dist.collective_launches().items() if v != before[k]}
        want_calls = {k: 3 * n for k, n in calls_of.get(label, {}).items()}
        if not want_calls:
            no_collective.append(label)
        log(f"  (a) {label} {tuple(x.shape)} {x.dtype}: staged {st.staged} (captures {st.captures}, replays "
            f"{st.replays}), equal to its one-rank value on each call {same}; collective calls over 3 runs "
            f"{got or 'none (the identity or a local op at one rank)'}; schedule {jf.schedule}")
        require(st.staged and st.captures == 1 and same, f"{label}: not staged, or not its one-rank value")
        require(got == want_calls, f"{label}: collective calls {got}, expected {want_calls}")
        del outs, want
    calls = {k: v - calls0[k] for k, v in dist.collective_launches().items()}
    jf, _ = compile_with_collectives(lambda a: dist.reduce_scatter(dist.all_gather(dist.all_reduce(a, "dp", 1), "dp", 1),
                                                                   "dp", 1), (emb,), None, (P(),), P())
    jf(emb), jf(emb)
    torch.cuda.synchronize()
    # traced(): a session whose lead-in takes the place of the records a
    # long process's profiler sessions lose at their start (PERF.md).
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        path = os.path.join(d, "replay.trace.json")
        with traced(path):
            jf(emb)
        events = _without_lead_in(load_trace_events(path))
    device_ops = sorted({str(e.get("name")) for e in _device_ops(events)})
    nccl = [k for k in device_ops if "nccl" in k.lower()]
    log(f"  (a) the port's collective calls over the staged prims above (a replay counts its capture's): {calls}; "
        f"staged with no collective at one rank: {no_collective}")
    log(f"  (a) device work of one replay of all_reduce -> all_gather -> reduce_scatter on {tuple(emb.shape)}: "
        f"{device_ops}; NCCL's own kernels among them: {nccl or 'none (one rank: a copy, or nothing)'}")
    # ppermute's only pair at one rank is (0, 0): a copy, no send or receive.
    require(all(v > 0 for k, v in calls.items() if k != "ppermute"), f"a collective was never called: {calls}")
    del grad, emb


def _dist_llama(mode: str, cfg, seed: int = SEED):
    """The stand-in from ``seed``, tagged by ``mode`` (None: untagged)."""
    from thunder_tpu_torch.distributed import FSDPType, ddp, fsdp

    m = llama(cfg, seed=seed, device="cuda")
    if mode == "ddp":
        return ddp(m)
    if mode in ("zero2", "zero3"):
        return fsdp(m, sharding_strategy=FSDPType.ZERO2 if mode == "zero2" else FSDPType.ZERO3)
    return m


def _dist_steps(m, ids, am, labels, ref=None, annotate: bool = False):
    """3 staged SGD steps of ``jit(m)`` (phase 11's), each step's loss and
    launches kept, and its grads: with ``ref`` (the untagged steps' grads,
    on the card), each checked ``torch.equal``; without, kept as ``ref``.
    Returns the jitted module, its optimizer and the steps' record."""
    import os

    import thunder_tpu_torch as tt

    if annotate:
        os.environ["THUNDER_ANNOTATE_TRACES"] = "1"
    try:
        tm = tt.jit(m)
        opt = torch.optim.SGD(m.parameters(), lr=LLAMA_LR)
        rec = {"losses": [], "counts": [], "times": [], "grads": [], "unequal": [], "peaks": []}
        for step in range(TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            _zero_counts()
            t = time.perf_counter()
            out = tm(ids, am, labels)
            out["loss"].backward()
            torch.cuda.synchronize()
            rec["times"].append(time.perf_counter() - t)
            rec["peaks"].append(torch.cuda.max_memory_allocated() - held)
            rec["counts"].append(_launch_counts())
            rec["losses"].append(out["loss"].detach().clone())
            del out
            grads = [p.grad for p in m.parameters()]
            if ref is None:
                rec["grads"].append([g.clone() for g in grads])
            else:
                rec["unequal"].append([n for (n, _), g, r in zip(m.named_parameters(), grads, ref["grads"][step])
                                       if not torch.equal(g, r)])
            del grads
            opt.step()
            opt.zero_grad(set_to_none=True)
    finally:
        if annotate:
            del os.environ["THUNDER_ANNOTATE_TRACES"]
    torch.cuda.synchronize()
    rec["peak_over_held"] = max(rec["peaks"][1:])
    cs = tm._lc_cs
    rec["staged"] = (cs.last_staging.staged, cs.last_backward_staging.staged)
    return tm, opt, rec


def run_dist_llama(launches: dict) -> None:
    """Phase 22 (b). The stand-in at open_llama_3b's full width and depth on
    phase 11's padded batch and weights (``llama`` from SEED): 3 staged SGD
    steps untagged, then under ddp, fsdp ZERO2 and fsdp ZERO3 on the one-rank
    NCCL group, each step's loss and every grad ``torch.equal`` to the
    untagged step's (every collective is the identity at one rank and
    grad_scale is 1), the kernels' launches a step equal, the collectives in
    the traces; ms a step, device ms (``profile_call``) and peak memory side
    by side (each step's peak over what it found allocated, the untagged
    grads kept for the comparison among that). The ddp module is compiled
    under THUNDER_ANNOTATE_TRACES=1, and (e) runs on it."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.observability import metrics as obsm

    gc.collect()
    torch.cuda.empty_cache()
    cfg = OPEN_LLAMA_3B
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    rows = {}

    def step_fn(tm, opt):
        def step():
            tm(ids, am, labels)["loss"].backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
        return step

    m = _dist_llama(None, cfg)
    tm, opt, ref = _dist_steps(m, ids, am, labels)
    rows["untagged"] = (ref, profile_call("llama_train_step_untagged", step_fn(tm, opt), batch=LOSS_BATCH, seq=SEQ,
                                          config="open_llama_3b", module="chip_smoke.LlamaForCausalLM", staged=True))
    del m, tm, opt
    gc.collect()
    torch.cuda.empty_cache()
    held_ref = sum(g.numel() * g.element_size() for gs in ref["grads"] for g in gs)
    for mode in DIST_MODES:
        m = _dist_llama(mode, cfg)
        if mode == "ddp":
            obsm.enable()
            before = obsm.COLLECTIVE_BYTES.value()
        tm, opt, rec = _dist_steps(m, ids, am, labels, ref=ref, annotate=mode == "ddp")
        fw, bw = tt.last_traces(tm)[-1], tt.last_backward_traces(tm)[-1]
        fw_src, bw_src = fw.python(), bw.python()
        colls = {"fw synchronize": fw_src.count("synchronize("), "bw all_reduce": bw_src.count("all_reduce("),
                 "bw reduce_scatter": bw_src.count("reduce_scatter("), "bw synchronize": bw_src.count("synchronize(")}
        if mode == "ddp":
            rec["collective_bytes_metric"] = obsm.COLLECTIVE_BYTES.value() - before
            obsm.disable()
        same_loss = all(torch.equal(a, b) for a, b in zip(rec["losses"], ref["losses"]))
        unequal = sorted({n for u in rec["unequal"] for n in u})
        log(f"  (b) {mode}: losses {', '.join(f'{x.item():.6f}' for x in rec['losses'])} (untagged "
            f"{', '.join(f'{x.item():.6f}' for x in ref['losses'])}), bit-equal {same_loss}; grads of every "
            f"param bit-equal at every step {not unequal}{'' if not unequal else f' (not: {unequal[:6]})'}; "
            f"launches a step equal to untagged {rec['counts'] == ref['counts']}; staged (forward, backward) "
            f"{rec['staged']}; collectives in the traces {colls}")
        require(same_loss and not unequal, f"{mode}: a loss or a grad differs from the untagged step's")
        require(rec["counts"] == ref["counts"], f"{mode}: launches {rec['counts']} differ from untagged "
                f"{ref['counts']}")
        require(rec["staged"] == (True, True), f"{mode}: the forward or backward is not staged")
        want_bw = "bw all_reduce" if mode == "ddp" else "bw reduce_scatter"
        require(colls["fw synchronize"] > 0 and colls[want_bw] > 0 and (colls["bw synchronize"] > 0) == (mode == "zero3"),
                f"{mode}: the traces lack their collectives ({colls})")
        rows[mode] = (rec, profile_call(f"llama_train_step_{mode}", step_fn(tm, opt), batch=LOSS_BATCH, seq=SEQ,
                                        config="open_llama_3b", module="chip_smoke.LlamaForCausalLM", staged=True))
        for c in rec["counts"]:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
        if mode == "ddp":
            # (e) now, while the ddp step's graphs hold their pools, and
            # before the next module needs the memory; then phase 23 (c)
            # on the same step.
            attr = run_dist_attribution(m, tm, opt, ids, am, labels, rec)
            log("[23] (c) the fleet timeline, driven by the staged ddp step of phase 22 (b)")
            run_timeline(step_fn(tm, opt), attr)
            del attr
        del m, tm, opt
        gc.collect()
        torch.cuda.empty_cache()
    ref_peak = rows["untagged"][0]["peak_over_held"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"  (b) on {smi}:")
    for mode, (rec, prof) in rows.items():
        log(f"  (b) {mode:8s}: s/step {', '.join(f'{x:.4f}' for x in rec['times'])}; device "
            f"{prof['device_ms']:.2f} ms/step; peak of a fw+bw over what it found allocated (steps 2-3) "
            f"{rec['peak_over_held'] / 2**30:.2f} GiB (untagged {ref_peak / 2**30:.2f})")
    log(f"  (b) the untagged steps' grads kept on the card for the comparison: {held_ref / 2**30:.2f} GiB")
    del ref


def run_dist_no_sync() -> None:
    """Phase 22 (c). no_sync at full width, 2 layers, under ddp: the padded
    batch's 2 rows as 2 microbatches of B=1 inside the context, each loss
    weighted by its row's share of the labelled positions, against one B=2
    step, within phase 4's limits; the no-sync backward holds no
    collective."""
    import thunder_tpu_torch as tt

    cfg2 = replace(OPEN_LLAMA_3B, num_hidden_layers=2)
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg2.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    m = _dist_llama("ddp", cfg2)
    tm = tt.jit(m)
    loss = tm(ids, am, labels)["loss"]
    loss.backward()
    want_loss, want = loss.item(), {n: p.grad.float() for n, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    counts = (labels != -100).sum(dim=1)
    total = 0.0
    with tm.no_sync():
        for k in range(LOSS_BATCH):
            part = tm(ids[k:k + 1], am[k:k + 1], labels[k:k + 1])["loss"] * (counts[k] / counts.sum())
            part.backward()
            total += part.item()
        bw_src = tt.last_backward_traces(tm)[-1].python()
    rels = {n: ((p.grad.float() - want[n]).norm() / want[n].norm().clamp_min(1e-30)).item()
            for n, p in m.named_parameters()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(total - want_loss) / abs(want_loss)
    has_coll = "all_reduce(" in bw_src or "reduce_scatter(" in bw_src
    log(f"  (c) no_sync, 2 microbatches of B=1 (rows' labelled positions {counts.tolist()}): loss {total:.6f} vs "
        f"one B=2 step {want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}); worst grad norm-relative "
        f"error {rels[worst]:.3e} on {worst} (limit {GRAD_REL:.3e}); a collective in the no-sync backward {has_coll}; "
        f"accumulator drained {not tm._nosync_accum}")
    require(loss_rel <= LOSS_REL and rels[worst] <= GRAD_REL, "no_sync's accumulated step differs from one B=2 step")
    require(not has_coll and not tm._nosync_accum, "the no-sync backward holds a collective, or sums were left")
    del m, tm, want
    gc.collect()
    torch.cuda.empty_cache()


def run_dist_checkpoint() -> None:
    """Phase 22 (d). The ZERO3 module's state (2 layers) saved through
    ``distributed.checkpoint`` with its specs, loaded (every leaf, sharded
    or replicated, on the card) into a fresh module drawn from another
    seed, ``torch.equal``."""
    import tempfile

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.distributed import checkpoint as ck
    from thunder_tpu_torch.distributed.runtime import P

    cfg2 = replace(OPEN_LLAMA_3B, num_hidden_layers=2)
    tm = tt.jit(_dist_llama("zero3", cfg2))
    state = tm.state_dict()
    specs = {k: P("fsdp") if k in tm._sharded else P() for k in state}
    fresh = tt.jit(_dist_llama("zero3", cfg2, seed=SEED + 1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        t = time.perf_counter()
        ck.save(state, d, specs=specs)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = ck.load(d, specs=specs)
        off_card = [k for k, v in loaded.items() if not v.is_cuda]
        fresh.load_state_dict(loaded)
        load_s = time.perf_counter() - t
        del loaded
    got = fresh.state_dict()
    unequal = [k for k in state if not torch.equal(got[k], state[k])]
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    log(f"  (d) ZERO3 state, {len(state)} tensors, {nbytes / 2**30:.2f} GiB ({len(tm._sharded)} sharded): saved in "
        f"{save_s:.2f} s, loaded into a fresh module in {load_s:.2f} s; every loaded leaf on the card "
        f"{not off_card}; bit-equal {not unequal}")
    require(not off_card, f"loaded leaves off the card: {off_card[:5]}")
    require(not unequal, f"the loaded state differs: {unequal[:5]}")
    del tm, fresh, state, got
    gc.collect()
    torch.cuda.empty_cache()


def run_dist_attribution(m, tm, opt, ids, am, labels, rec):
    """Phase 22 (e). The staged ddp step of (b) (compiled annotated),
    profiled over 3 steps and attributed through the launch-order map of
    its eager step (phase 21 (c)'s route): the collective rows, and the
    compile's COLLECTIVE_BYTES against the collective operands of its
    traces and ``cost.py``'s wire bytes for them."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.analysis.cost import trace_cost
    from thunder_tpu_torch.observability.attribution import eager_stages, scope_map_of

    def step():
        tm(ids, am, labels)["loss"].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    with eager_stages(tm):
        lmap = scope_map_of(step)
    # The graphs hold the programs' lines only: what the eager step ran
    # outside them (autograd's ones, the SGD update) is left out of the map.
    lmap = [(name, scope) for name, scope in lmap if scope is not None]
    res = tt.profile(step, steps=3, warmup=0, launch_map=lmap)
    fw, bw = tt.last_traces(tm)[-1], tt.last_backward_traces(tm)[-1]
    join = monitor.attribution_report(res["trace_dir"], traces=[fw, bw], device="h100", steps=3, launch_map=lmap)
    attr = join.attribution
    rows = sorted(attr.collectives.values(), key=lambda r: -r.us)
    by_cls = attr.collective_summary()
    log(f"  (e) ddp step attributed: {attr.coverage:.2%} of {attr.device_busy_us / 3e3:.2f} device ms a step, graph "
        f"kernels {attr.graph_placed} of {attr.graph_ops} placed (a {len(lmap)}-op map; graph kernels by step "
        f"{attr.graph_steps}, {attr.graph_mismatched} differing from the map); collective rows {len(rows)}, "
        f"{attr.collective_us / 3e3:.4f} ms a step ({attr.exposed_collective_us / 3e3:.4f} exposed); by family "
        + ", ".join(f"{c}: {r.us / 3e3:.4f} ms x{r.count / 3:g}" for c, r in by_cls.items()))
    for r in rows[:5]:
        log(f"  (e)   {r.key:50s} {r.cls:14s} {r.us / 3e3:8.4f} ms a step, {r.count / 3:g} device ops, hidden "
            f"{r.hidden_us / 3e3:.4f} ms")
    tags = sum(t.tags.get("collective_bytes") or 0 for t in (fw, bw))
    wire = sum(trace_cost(t, "h100").total_comm_bytes for t in (fw, bw))
    param_bytes = sum(p.numel() * p.element_size() for p in m.parameters())
    log(f"  (e) COLLECTIVE_BYTES of the ddp compile {rec['collective_bytes_metric'] / 1e9:.4f} GB (the forward's and "
        f"backward's collective operands by their tags {tags / 1e9:.4f} GB, {tags / param_bytes:.3f}x the params' "
        f"bytes); cost.py's ring wire bytes for the same traces at one rank {wire:.0f} B (each collective's factor "
        "(g-1)/g is 0 at g=1)")
    require(rows and all(r.cls == "all-reduce" for r in rows), f"the ddp step's collective rows: {rows[:3]}")
    require(rec["collective_bytes_metric"] == tags and tags > 0, "COLLECTIVE_BYTES differs from the traces' tags")
    require(wire == 0.0, "cost.py priced wire bytes on a one-rank group")
    return attr


TIMELINE_STEPS = 20


def run_timeline(step, attr) -> None:
    """Phase 23 (c). The fleet timeline driven by phase 22 (b)'s staged ddp
    step (the driver ``monitor.critpath`` expects: the port's step has no
    hook of its own): 20 steps, each one's wall span folded with the
    collective rows (e) attributed to a step (exposed collective time as
    ``exposed_ici``, the rest of the device's busy time as ``compute``).
    Each breakdown's classes must sum to the step's wall within 1e-9
    relative, and the replay of the recorder's event log must know every
    record."""
    import os
    import tempfile

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis.events import replay_events
    from thunder_tpu_torch.observability import events as ev
    from thunder_tpu_torch.observability.detect import DetectorBank

    exposed_s = attr.exposed_collective_us / 3e6
    coll_s = attr.collective_us / 3e6
    busy_s = attr.device_busy_us / 3e6
    with tempfile.TemporaryDirectory(prefix="chip_smoke_timeline_") as d:
        path = os.path.join(d, "timeline.jsonl")
        ev.set_global_path(path)
        rec = monitor.critpath(emulated_skew_s={0: 0.0}, bank=DetectorBank())
        try:
            bds = []
            for i in range(TIMELINE_STEPS):
                t = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                rec.note_collective(0, i, fn="ddp_step", s=coll_s, step=i)
                bds.append(rec.record_step(i, {0: {"total_s": wall, "ici_s": exposed_s,
                                                   "compute_s": max(0.0, busy_s - exposed_s)}}))
            report = monitor.critpath_report()
            totals, fractions = rec.ledger.totals(), rec.ledger.fractions()
        finally:
            monitor.shutdown_critpath()
            ev.set_global_path(None)
        summary, diags = replay_events(path)
    worst = max(abs(sum(bd.classes.values()) - bd.total_s) / bd.total_s for bd in bds)
    walls = [bd.total_s * 1e3 for bd in bds]
    unknown = [d.message for d in diags if d.rule == "events.unknown-kind"]
    log(f"  (c) {TIMELINE_STEPS} ddp steps folded: wall {min(walls):.2f}-{max(walls):.2f} ms a step; class fractions "
        "(EWMA) " + ", ".join(f"{c} {fractions.get(c, 0.0):.4f}" for c in ("compute", "exposed_ici", "exposed_dcn",
                                                                           "straggler_wait", "stall", "idle"))
        + f"; worst |sum(classes) - wall| / wall {worst:.2e}")
    log(f"  (c) exposed_ici {totals['exposed_ici'] / TIMELINE_STEPS * 1e3:.4f} ms a step in the ledger; attribution's "
        f"collective rows (e) {coll_s * 1e3:.4f} ms a step, {exposed_s * 1e3:.4f} exposed, of {busy_s * 1e3:.2f} device "
        "ms")
    for line in (report or "").splitlines():
        log(f"  (c) | {line}")
    log(f"  (c) replay of the recorder's event log: kinds {summary.get('kinds')}, unknown kinds {len(unknown)}")
    _NOTES["timeline_exposed_pct"] = rec.measured_exposed_pct()
    require(worst <= 1e-9, f"a step's classes do not sum to its wall ({worst:.2e})")
    require(abs(totals["exposed_ici"] / TIMELINE_STEPS - exposed_s) <= 1e-9 * max(exposed_s, 1e-9) + 1e-12,
            "the ledger's exposed_ici differs from attribution's exposed collective time")
    require(not unknown and summary.get("kinds", {}).get("critpath_step") == TIMELINE_STEPS
            and summary.get("kinds", {}).get("collective") == TIMELINE_STEPS,
            f"the replay: unknown {unknown[:3]}, kinds {summary.get('kinds')}")


# Phase 23 (a): the kernel rows a step of open_llama_3b's training program
# launches (26 layers: q and k through rope forward and backward).
MESH_STEP_LAUNCHES = {"flash_fwd_lse": 26, "flash_bwd": 26, "rope": 104, "ce_fwd": 1, "ce_bwd": 1}


def _mesh_step_run(cfg, ids, tgt, optimizer: str, mesh=None) -> dict:
    """TRAIN_STEPS staged steps of ``build_train_step`` from SEED's weights
    (sharded by ``gpt_param_specs`` and ``shard_pytree`` onto ``mesh`` when
    given), donated; each step's launches and loss, the peak of steps 2-3,
    the params after the last step on the host, the collectives of the
    program and the NCCL calls made, then ``profile_call``."""
    from collections import Counter

    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.distributed import prims as dprims
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step, gpt_param_specs, shard_pytree

    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda")
    kw = dict(donate=True, grads_in_f32=optimizer != "sgd", optimizer=optimizer, return_extrace=True)
    t = time.perf_counter()
    if mesh is not None:
        specs = gpt_param_specs(cfg, mesh)
        params = shard_pytree(params, mesh, specs)
        step, opt, ex = build_train_step(cfg, params, ids, tgt, mesh=mesh, param_specs=specs, **kw)
    else:
        step, opt, ex = build_train_step(cfg, params, ids, tgt, **kw)
    build_s = time.perf_counter() - t
    state = {"p": params, "o": opt}
    del params, opt
    before = dprims.collective_launches()
    losses, counts = [], []
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        state["p"], state["o"], loss = step(state["p"], state["o"], ids, tgt)
        torch.cuda.synchronize()
        counts.append(_launch_counts())
        losses.append(loss.detach().clone())
    peak = torch.cuda.max_memory_allocated()
    calls = {k: v - before[k] for k, v in dprims.collective_launches().items() if v != before[k]}
    final = [x.detach().to("cpu") for x in tree_flatten(state["p"])[0]]

    def one():
        state["p"], state["o"], _ = step(state["p"], state["o"], ids, tgt)

    label = f"open_llama_3b_train_step_{optimizer}_{'mesh' if mesh is not None else 'unmeshed'}"
    prof = profile_call(label, one, batch=LOSS_BATCH, seq=SEQ, config=CFG_NAME, staged=True)
    out = {"losses": losses, "counts": counts, "peak": peak, "final": final, "calls": calls, "build_s": build_s,
           "staged": step.staging.staged, "prof": prof,
           "program": dict(Counter(b.sym.name for b in ex.bound_symbols if dprims.is_collective_bsym(b)))}
    del step, state, ex
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_mesh_step(launches: dict) -> None:
    """Phase 23 (a). The sharded step on the mesh of one NCCL rank against
    the unmeshed step, SGD then AdamW, at open_llama_3b's full size."""
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import make_mesh

    cfg = gpt.name_to_config(CFG_NAME)
    gen = np.random.RandomState(SEED)
    idx_np = gen.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))
    ids = torch.from_numpy(idx_np).cuda()
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).cuda()
    mesh = make_mesh(dp=1, fsdp=1, tp=1)
    log(f"  (a) mesh {mesh.shape}, groups bound to {sorted(mesh)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for optimizer in ("sgd", "adamw"):
        ref = _mesh_step_run(cfg, ids, tgt, optimizer)
        got = _mesh_step_run(cfg, ids, tgt, optimizer, mesh=mesh)
        same_loss = all(torch.equal(a, b) for a, b in zip(ref["losses"], got["losses"]))
        unequal = sum(not torch.equal(a, b) for a, b in zip(ref["final"], got["final"]))
        per_step = [{k: c[k] for k in MESH_STEP_LAUNCHES} for c in got["counts"]]
        log(f"  (a) {optimizer}: losses {', '.join(f'{x.item():.6f}' for x in got['losses'])} (unmeshed "
            f"{', '.join(f'{x.item():.6f}' for x in ref['losses'])}), bit-equal {same_loss}; params after step "
            f"{TRAIN_STEPS} bit-equal {unequal == 0} ({len(got['final'])} leaves, {unequal} differ); launches a step "
            f"{per_step[-1]}, equal to the unmeshed step's {got['counts'] == ref['counts']}; staged "
            f"{got['staged']} (unmeshed {ref['staged']}); build {got['build_s']:.2f} s (unmeshed "
            f"{ref['build_s']:.2f} s)")
        log(f"  (a) {optimizer} on {smi}: device {got['prof']['device_ms']:.2f} ms a step (unmeshed "
            f"{ref['prof']['device_ms']:.2f}); enqueue {_median(got['prof']['enqueue_ms']):.2f} ms (unmeshed "
            f"{_median(ref['prof']['enqueue_ms']):.2f}); wall {min(got['prof']['wall_ms']):.2f} ms (unmeshed "
            f"{min(ref['prof']['wall_ms']):.2f}); max_memory_allocated steps 2-{TRAIN_STEPS} "
            f"{got['peak'] / 2**30:.2f} GiB (unmeshed {ref['peak'] / 2**30:.2f})")
        log(f"  (a) {optimizer}: collectives in the program at one rank {got['program'] or 'none'}; NCCL calls made "
            f"by family {got['calls'] or 'none'}")
        require(same_loss and unequal == 0, f"{optimizer}: the meshed step differs from the unmeshed one")
        require(got["counts"] == ref["counts"] and all(c == MESH_STEP_LAUNCHES for c in per_step),
                f"{optimizer}: launches {per_step} (unmeshed {[{k: c[k] for k in MESH_STEP_LAUNCHES} for c in ref['counts']]})")
        require(got["staged"] and ref["staged"], f"{optimizer}: a step is not staged")
        require(abs(got["peak"] - ref["peak"]) <= 2**30, f"{optimizer}: peak {got['peak']} vs {ref['peak']}")
        for c in got["counts"] + ref["counts"]:
            for k in MESH_STEP_LAUNCHES:
                launches[k] = launches.get(k, 0) + c[k]
        del ref, got


def run_mesh_cli() -> None:
    """Phase 23 (b). The LitGPT CLI as the ranks of ``run_config("dp1")``
    (one process, on this card): pythia-410m, B=2, T=2048, AdamW. With
    ``WORLD_SIZE`` set the CLI takes the mesh path at a mesh of one
    (``distributed.init`` on NCCL, ``make_mesh``, ``shard_pytree``, the
    sharded step), and its line's ``process_group`` shows it."""
    from thunder_tpu_torch.benchmarks.distributed import run_config

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out = run_config("dp1", model=PYTHIA, micro_batch=LOSS_BATCH, seq=SEQ, iters=3, device="cuda",
                     extra=["--warmup", "2"], timeout=600)
    log(f"  (b) run_config('dp1', {PYTHIA}) in {time.perf_counter() - t:.1f} s: {json.dumps(out)}")
    require("error" not in out, f"the CLI's ranks failed: {out.get('error')}")
    require(out.get("process_group") == {"backend": "nccl", "world": 1},
            f"the CLI did not run the sharded step on a one-rank NCCL group: {out}")
    require(math.isfinite(out["loss_first"]) and out["tokens_per_sec"] > 0, f"rank 0's line: {out}")


# =============================================================================
# Phase 24: context, pipeline and expert parallelism (parallel/)
# =============================================================================

# The claimed names of rows 1-7 in a stage program (row 1 is the forward
# without residuals, which 1F1B's stage forward claims on every stage but
# the last: at pp=1 it does not launch).
PP_CLAIM_ROWS = {**CLAIM_ROWS, "flash_scaled_dot_product_attention(": "flash_fwd"}
PP_ROWS = ("flash_fwd", "flash_fwd_lse", "flash_bwd", "rope", "ce_fwd", "ce_bwd")
PP_MICRO = 4
# Phase 24 (a)'s depth, cut from the model's 26 (width kept) to keep the
# whole script inside its time budget: the pipelined and the unpipelined
# programs are compared at the same depth.
PP_LAYERS = 13


def _pp_expected(step) -> dict:
    """The launches of rows 1-7 a pipelined step makes: each claimed
    program's sites times its calls a step (1F1B: the stage forward, which
    the last stage has not, and the recompute-and-VJP once a microbatch;
    GPipe: the joint program once)."""
    st = step.schedule.stats if step.schedule is not None else None
    calls = [1] if st is None else [st["fwd_calls"]] * (len(step.traces) - 1) + [st["bwd_calls"]]
    out: dict = {}
    for tr, n in zip(step.traces, calls):
        src = tr.python()
        for op, row in PP_CLAIM_ROWS.items():
            if row in PP_ROWS and src.count(op):
                out[row] = out.get(row, 0) + n * src.count(op)
    return out


def _leaf_names(tree, path: str = "") -> list:
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{path}/{i}")]
    return [path]


def _against_reference(loss, grads, ref_loss: float, ref_grads: list) -> tuple:
    """(loss relative gap, worst norm-relative grad gap, its leaf) of a
    pipelined step's against the unpipelined program's (the same leaf
    order)."""
    from thunder_tpu_torch.core.pytree import tree_flatten

    worst, where = 0.0, ""
    for g, w, nm in zip(tree_flatten(grads)[0], ref_grads, _leaf_names(grads)):
        w = w.to(g.device, torch.float32)
        rel = ((g.float() - w).norm() / w.norm().clamp_min(1e-30)).item()
        if not math.isfinite(rel) or rel > worst:
            worst, where = rel if math.isfinite(rel) else float("inf"), nm
    return abs(float(loss) - ref_loss) / abs(ref_loss), worst, where


def run_pipelined(launches: dict) -> None:
    """Phase 24 (a). open_llama_3b's pipelined step at PP_LAYERS layers on a mesh
    with pp=1: GPipe and 1F1B through ``gpt_pp_loss_and_grads``
    (n_micro=4, mb=1, the default executors) against the unpipelined
    program on the same B=4 batch and weights; launches against the
    claimed stage programs; peaks, device ms, a planted fault."""
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step, make_mesh
    from thunder_tpu_torch.parallel import gpt_pp

    cfg = replace(gpt.name_to_config(CFG_NAME), n_layer=PP_LAYERS)
    mesh = make_mesh(pp=1)
    gen = np.random.RandomState(SEED + 24)
    idx_np = gen.randint(0, cfg.vocab_size, (PP_MICRO, SEQ))
    ids = torch.from_numpy(idx_np).cuda()
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).cuda()
    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda")
    flat_p = tree_flatten(params)[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    # The unpipelined program: one joint fw+bw over B=4, its grads kept on the host.
    ref, _ = build_train_step(cfg, params, ids, tgt, donate=False, optimizer="sgd")
    torch.cuda.reset_peak_memory_stats()
    ref_loss, ref_grads = ref.loss_and_grads(*flat_p, ids, tgt)
    torch.cuda.synchronize()
    ref_peak = torch.cuda.max_memory_allocated()
    ref_loss = float(ref_loss)
    ref_grads = [g.to("cpu") for g in ref_grads]
    prof_ref = profile_call("open_llama_3b_unpipelined_B4", lambda: ref.loss_and_grads(*flat_p, ids, tgt), batch=PP_MICRO,
                            seq=SEQ, config=CFG_NAME, staged=False)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) unpipelined B={PP_MICRO} on {smi}: loss {ref_loss:.6f}, device {prof_ref['device_ms']:.2f} ms, "
        f"max_memory_allocated {ref_peak / 2**30:.2f} GiB")

    peaks = {}
    for sched in ("gpipe", "1f1b"):
        t = time.perf_counter()
        results, counts = [], []
        for call in range(3):  # eager, capture, replay
            if call == 1:
                torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            loss, grads = gpt_pp.gpt_pp_loss_and_grads(cfg, params, ids, tgt, mesh, n_micro=PP_MICRO,
                                                       schedule=sched, executors=None)
            torch.cuda.synchronize()
            counts.append({k: v for k, v in _launch_counts().items() if k in PP_ROWS and v})
            results.append(_against_reference(loss, grads, ref_loss, ref_grads))
            if call == 0:
                first_s = time.perf_counter() - t
            del grads
        peaks[sched] = torch.cuda.max_memory_allocated()
        step = gpt_pp.gpt_pp_loss_and_grads.last_step
        expected = _pp_expected(step)
        st = step.staging
        log(f"  (a) {sched}: loss gap {results[-1][0]:.3e} (limit {LOSS_REL:.0e}), worst grad {results[-1][1]:.3e} on "
            f"{results[-1][2]} (limit {GRAD_REL:.3e}); calls 1-3 gaps {[f'{r[0]:.2e}/{r[1]:.2e}' for r in results]}; "
            f"first call {first_s:.1f} s; launches a step {counts[-1]} (claimed sites x calls {expected}); "
            f"{'stash ' + str(step.schedule.stats) + '; ' if step.schedule is not None else ''}staging: staged "
            f"{st.staged}, captures {st.captures}, replays {st.replays}, first call {st.first_call_s:.2f} s, capture "
            f"{st.capture_s:.2f} s, bytes copied a call {st.copied_bytes_per_call}")
        for loss_gap, worst, where in results:
            require(loss_gap <= LOSS_REL and worst <= GRAD_REL,
                    f"{sched}: the pipelined step differs from the unpipelined one: loss {loss_gap:.3e}, {where} "
                    f"{worst:.3e}")
        require(all(c == expected for c in counts), f"{sched}: launches {counts}, claimed {expected}")
        require(st.staged and st.captures == 1 and st.replays >= 1, f"{sched}: not staged and replayed: {st}")
        for c in counts:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
        if sched == "1f1b":
            require(step.schedule.stats["stash_peak"] <= 1, f"1f1b stash {step.schedule.stats}")
            # The planted fault: microbatch 2's targets rolled by one in the
            # stream the last stage reads.
            bad = tgt.clone()
            bad[2] = torch.roll(tgt[2], 1)
            loss, grads = gpt_pp.gpt_pp_loss_and_grads(cfg, params, ids, bad, mesh, n_micro=PP_MICRO, schedule=sched,
                                                       executors=None)
            gap, worst, where = _against_reference(loss, grads, ref_loss, ref_grads)
            del grads
            log(f"  (a) planted fault (microbatch 2's targets rolled): loss gap {gap:.3e}, worst grad {worst:.3e} "
                f"on {where}")
            require(gap > LOSS_REL or worst > GRAD_REL, "the rolled targets were not seen")

        def one():
            gpt_pp.gpt_pp_loss_and_grads(cfg, params, ids, tgt, mesh, n_micro=PP_MICRO, schedule=sched,
                                         executors=None)

        prof = profile_call(f"open_llama_3b_pipelined_{sched}", one, batch=PP_MICRO, seq=SEQ, config=CFG_NAME,
                            staged=True)
        log(f"  (a) {sched} on {smi}: device {prof['device_ms']:.2f} ms a step (unpipelined B={PP_MICRO} "
            f"{prof_ref['device_ms']:.2f}); enqueue {_median(prof['enqueue_ms']):.2f} ms; wall "
            f"{min(prof['wall_ms']):.2f} ms; max_memory_allocated calls 2-3 {peaks[sched] / 2**30:.2f} GiB")
        del step
        gpt_pp.gpt_pp_loss_and_grads.last_step = None
        gc.collect()
        torch.cuda.empty_cache()
    require(peaks["1f1b"] < peaks["gpipe"], f"1F1B's peak {peaks['1f1b']} is not under GPipe's {peaks['gpipe']}")


# Phase 24 (b): mixtral-8x7b's expert MLP, f32 (the JAX function's type).
MOE_E, MOE_D, MOE_H, MOE_N, MOE_TOPK = 8, 4096, 14336, 4096, 2


def _allclose_ratio(got, want, rtol: float, atol: float) -> float:
    """max |got − want| / (atol·max|want| + rtol·|want|): at most 1 is
    allclose with the absolute part taken relative to the tensor's largest
    |value|."""
    want = want.float()
    return ((got.float() - want).abs() / (atol * want.abs().max() + rtol * want.abs())).max().item()


def run_moe(mesh) -> None:
    """Phase 24 (b). ``moe_mlp`` at ep=1 and mixtral-8x7b's widths against
    ``moe_mlp_dense_reference``: values and router/w1/w2 grads with the
    no-drop capacity; a control with the router softmax and the einsums in
    bf16, which the limits must fail; the drops at capacity
    ceil(1.25·top_k·n/E) against a host replication of the slot
    accounting; a planted fault."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.parallel import moe

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    # Tokens with a common mean, as hidden states have: each expert's
    # logits get an offset of their own, so the routing is unbalanced and
    # the capacity drops.
    x = torch.randn(MOE_N, MOE_D, generator=gen, device="cuda") + 1.0
    rw = torch.randn(MOE_D, MOE_E, generator=gen, device="cuda") / math.sqrt(MOE_D)
    w1 = torch.randn(MOE_E, MOE_D, MOE_H, generator=gen, device="cuda") / math.sqrt(MOE_D)
    w2 = torch.randn(MOE_E, MOE_H, MOE_D, generator=gen, device="cuda") / math.sqrt(MOE_H)
    args = (x, rw, w1, w2)
    cap = math.ceil(1.25 * MOE_TOPK * MOE_N / MOE_E)
    with runtime.bound_axes(runtime.mesh_groups(mesh)):
        t = time.perf_counter()
        got = tt.jit(lambda *a: moe.moe_mlp(*a, "ep", top_k=MOE_TOPK))(*args)
        want = tt.jit(lambda *a: moe.moe_mlp_dense_reference(*a, top_k=MOE_TOPK))(*args)
        _, g_ep = tt.value_and_grad(lambda *a: ttorch.sum(moe.moe_mlp(*a, "ep", top_k=MOE_TOPK) ** 2))(*args)
        _, g_dn = tt.value_and_grad(lambda *a: ttorch.sum(moe.moe_mlp_dense_reference(*a, top_k=MOE_TOPK) ** 2))(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        val = _allclose_ratio(got, want, 1e-4, 1e-5)
        grads = [_allclose_ratio(a, b, 1e-3, 1e-4) for a, b in zip(g_ep[1:], g_dn[1:])]
        log("  (b) router, w1, w2 grads: largest |value| "
            f"{[round(b.abs().max().item(), 3) for b in g_dn[1:]]}, largest |gap| "
            f"{[float(f'{(a - b).abs().max().item():.3e}') for a, b in zip(g_ep[1:], g_dn[1:])]}, norm-relative gap "
            f"{[float(f'{((a - b).norm() / b.norm()).item():.3e}') for a, b in zip(g_ep[1:], g_dn[1:])]}")
        on_card = all(t.device.type == "cuda" for t in (got, want, *g_ep, *g_dn))
        del g_ep
        log(f"  (b) moe_mlp (E={MOE_E}, d={MOE_D}, h={MOE_H}, n={MOE_N}, top-{MOE_TOPK}, f32) against the dense "
            f"oracle: values {val:.3f} of rtol 1e-4/atol 1e-5 (atol of the largest |value|); router, w1, w2 grads "
            f"{', '.join(f'{r:.3f}' for r in grads)} of 1e-3/1e-4; on the card {on_card}; {secs:.1f} s")
        require(val <= 1.0 and all(r <= 1.0 for r in grads) and on_card, "moe_mlp differs from the dense oracle")

        # The control: moe_mlp with the router softmax and every einsum in
        # bf16. The limits must see it in the values and in each grad.
        class _Bf16Einsums:
            def __getattr__(self, name):
                return getattr(ttorch, name)

            @staticmethod
            def einsum(eq, *ops):
                return ttorch.einsum(eq, *[o.to(torch.bfloat16) for o in ops]).float()

            @staticmethod
            def softmax(a, dim):
                return ttorch.softmax(a.to(torch.bfloat16), dim).float()

        moe.ttorch = _Bf16Einsums()
        try:
            ctl = tt.jit(lambda *a: moe.moe_mlp(*a, "ep", top_k=MOE_TOPK))(*args)
            _, g_ctl = tt.value_and_grad(lambda *a: ttorch.sum(moe.moe_mlp(*a, "ep", top_k=MOE_TOPK) ** 2))(*args)
        finally:
            moe.ttorch = ttorch
        ctl_val = _allclose_ratio(ctl, want, 1e-4, 1e-5)
        ctl_grads = [_allclose_ratio(a, b, 1e-3, 1e-4) for a, b in zip(g_ctl[1:], g_dn[1:])]
        log(f"  (b) control (router softmax and einsums in bf16): values {ctl_val:.3f} of the limit; router, w1, w2 "
            f"grads {', '.join(f'{r:.3f}' for r in ctl_grads)}; norm-relative grad gap "
            f"{[float(f'{((a - b).norm() / b.norm()).item():.3e}') for a, b in zip(g_ctl[1:], g_dn[1:])]}")
        require(ctl_val > 1.0 and all(r > 1.0 for r in ctl_grads), "the limits do not see bf16 einsums")
        del ctl, g_ctl, g_dn

        # Drops at capacity `cap`, against the slot accounting replicated on
        # the host over the card's router probabilities.
        out_c = tt.jit(lambda *a: moe.moe_mlp(*a, "ep", top_k=MOE_TOPK, capacity=cap))(*args)
        dispatch, _ = tt.jit(lambda x, rw: moe.dispatch_plan(x, rw, MOE_E, MOE_TOPK, cap))(x, rw)
        probs = tt.jit(lambda x, rw: ttorch.softmax(ttorch.matmul(x, rw), -1))(x, rw)

        def topk_ids(t, k, **kw):
            return tt.jit(lambda p: ttorch.topk(p, k, -1)[1], **kw)(t)

        top_i, cpu_i = topk_ids(probs, MOE_TOPK), topk_ids(probs.cpu(), MOE_TOPK, device="cpu")
        p = probs.cpu().numpy()
        order = np.argsort(-p, axis=-1, kind="stable")[:, :MOE_TOPK]
        used, kept, dropped_rows = np.zeros(MOE_E, int), 0, 0
        for row in order:
            k_row = 0
            for e in row:
                if used[e] < cap:
                    kept += 1
                    k_row += 1
                used[e] += 1
            dropped_rows += k_row == 0
        port_kept = int(dispatch.sum().item())
        zero_rows = int((out_c.abs().amax(1) == 0).sum().item())
        ties = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0, 0.5, 0.0, 0.0]], device="cuda")
        tie_card, tie_cpu = topk_ids(ties, 3).tolist(), topk_ids(ties.cpu(), 3, device="cpu").tolist()
        log(f"  (b) capacity {cap}: kept {port_kept} of {MOE_N * MOE_TOPK} assignments (host replication {kept}), "
            f"dropped {MOE_N * MOE_TOPK - port_kept}; fully dropped tokens {zero_rows} exact zero rows (host "
            f"{dropped_rows}); topk on the card equals the CPU's on the router probabilities "
            f"{torch.equal(top_i.cpu(), cpu_i)} and the host's stable order {bool((order == cpu_i.numpy()).all())}; "
            f"on ties (0.5 at 1, 3, 5) the card picks {tie_card}, the CPU {tie_cpu}")
        require(port_kept == kept and zero_rows == dropped_rows and MOE_N * MOE_TOPK > kept,
                "the capacity's drops differ from the host's slot accounting")
        require(torch.equal(top_i.cpu(), cpu_i), "topk on the card differs from the CPU's")
        require(tie_card == tie_cpu == [[1, 3, 5]], "topk does not break ties lower index first (lax.top_k's order)")
        del out_c, dispatch, probs

        # The planted fault: the router weights left out of the combine.
        plan = moe.dispatch_plan
        moe.dispatch_plan = lambda *a: (plan(*a)[0],) * 2
        try:
            bad = tt.jit(lambda *a: moe.moe_mlp(*a, "ep", top_k=MOE_TOPK))(*args)
        finally:
            moe.dispatch_plan = plan
        ratio = _allclose_ratio(bad, want, 1e-4, 1e-5)
        log(f"  (b) planted fault (no router weights in the combine): {ratio:.3e} of the limit")
        require(ratio > 1.0, "the combine without router weights was not seen")
    del args, x, w1, w2, got, want, bad
    gc.collect()
    torch.cuda.empty_cache()


def _exact_attention_grads(q, k, v, dout, scale: float) -> list:
    """Causal attention's grads in f32 by torch.autograd of the plain
    product (the scores materialized), from the bf16 inputs."""
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * scale
    S = s.shape[-1]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=s.device).tril(), float("-inf"))
    (torch.softmax(s, -1) @ vf).mul(dout.float()).sum().backward()
    return [t.grad for t in (qf, kf, vf)]


def run_context(mesh) -> None:
    """Phase 24 (c). Ring and Ulysses attention at sp=1 on open_llama_3b's
    attention shape against the flash kernel (row 1) and its backward (row
    7) within phase 3's limits; a planted fault; every output on the card."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.parallel import context

    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config(CFG_NAME)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    shape = (1, cfg.n_head, SEQ, cfg.head_size)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(cfg.head_size)
    want = flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
    want_g = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)
    eps = 2.0 ** -7
    with runtime.bound_axes(runtime.mesh_groups(mesh)):
        for name, fn in (("ring", context.ring_attention), ("ulysses", context.ulysses_attention)):
            got = tt.jit(lambda q, k, v: fn(q, k, v, "sp"))(q, k, v)
            _, grads = tt.value_and_grad(lambda q, k, v, d: ttorch.sum(fn(q, k, v, "sp").float() * d.float()))(
                q, k, v, dout)
            rel = row_rel_err(got, want)
            # Against the flash backward: dk and dv row by row; dq over the
            # tensor (norm-relative), since the flash backward's rows whose
            # exact dq nearly cancels hold its bf16 rounding of O in
            # rowsum(dO·O) (its plain version shares it, so phase 3 cannot
            # see it). Every grad is held row by row against exact f32.
            g_rel = [((grads[0].float() - want_g[0].float()).norm() / want_g[0].float().norm()).item()]
            g_rel += [row_rel_err(g, w, floor=eps * eps) for g, w in zip(grads[1:3], want_g[1:])]
            exact = _exact_attention_grads(q, k, v, dout, scale)
            x_rel = [row_rel_err(g, w, floor=eps * eps) for g, w in zip(grads[:3], exact)]
            f_rel = [row_rel_err(g, w, floor=eps * eps) for g, w in zip(want_g, exact)]
            del exact
            on_card = all(t.device.type == "cuda" for t in (got, *grads))
            log(f"  (c) {name} attention {shape} bf16 causal at sp=1 against the flash kernel: row_rel_err {rel:.3e} "
                f"(limit {FLASH_ROW_REL:.3e}); grads q (norm-relative), k, v against the flash backward "
                f"{', '.join(f'{r:.3e}' for r in g_rel)}, against exact f32 {', '.join(f'{r:.3e}' for r in x_rel)} "
                f"(limit {FLASH_BWD_ROW_REL:.3e}); the flash backward against exact f32 "
                f"{', '.join(f'{r:.3e}' for r in f_rel)}; on the card {on_card}")
            require(rel <= FLASH_ROW_REL and max(g_rel + x_rel) <= FLASH_BWD_ROW_REL and on_card,
                    f"{name} attention differs from the flash kernel")
            del got, grads
        normalize = context._normalize
        context._normalize = lambda o, l, dtype: o.to(dtype)
        try:
            bad = tt.jit(lambda q, k, v: context.ring_attention(q, k, v, "sp"))(q, k, v)
        finally:
            context._normalize = normalize
        rel = row_rel_err(bad, want)
        log(f"  (c) planted fault (the ring's 1/l left out): row_rel_err {rel:.3e}")
        require(rel > FLASH_ROW_REL, "the ring without its 1/l was not seen")
    gc.collect()
    torch.cuda.empty_cache()


def run_axes_at_one(cfg, launches: dict) -> None:
    """Phase 24 (d). ``build_train_step`` on a mesh naming pp, ep and sp
    (all 1) against the unmeshed step, phase 23 (a)'s comparison at 2
    layers: losses and params bit-equal, the launches equal."""
    from thunder_tpu_torch.parallel import make_mesh

    two = replace(cfg, n_layer=2)
    gen = np.random.RandomState(SEED)
    idx_np = gen.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))
    ids = torch.from_numpy(idx_np).cuda()
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).cuda()
    ref = _mesh_step_run(two, ids, tgt, "sgd")
    got = _mesh_step_run(two, ids, tgt, "sgd", mesh=make_mesh(pp=1, ep=1, sp=1))
    same = all(torch.equal(a, b) for a, b in zip(ref["losses"], got["losses"]))
    unequal = sum(not torch.equal(a, b) for a, b in zip(ref["final"], got["final"]))
    log(f"  (d) make_mesh(pp=1, ep=1, sp=1), {two.n_layer} layers, SGD: losses bit-equal {same}, params after step "
        f"{TRAIN_STEPS} bit-equal {unequal == 0} ({unequal} of {len(got['final'])} differ); launches equal "
        f"{got['counts'] == ref['counts']}; collectives in the program {got['program'] or 'none'}")
    require(same and unequal == 0 and got["counts"] == ref["counts"] and not got["program"],
            "the mesh naming pp, ep and sp differs from the unmeshed step")
    for c in got["counts"]:
        for k in MESH_STEP_LAUNCHES:
            launches[k] = launches.get(k, 0) + c[k]


# =============================================================================
# Phase 25: the recovery layer (thunder_tpu_torch/resilience)
# =============================================================================

P25_STEPS = 4
P25_LR = 1e-4
P25_OOM_LAYERS = 4
NAN_GUARD_CALLS = 10


def _p25_batches(vocab: int) -> list:
    """One (ids, targets) batch a step, from SEED: step k reads batch k (the
    data order a resumed run must restore)."""
    gen = np.random.RandomState(SEED + 25)
    out = []
    for _ in range(P25_STEPS):
        a = gen.randint(0, vocab, (LOSS_BATCH, SEQ))
        out.append((torch.from_numpy(a).cuda(), torch.from_numpy(np.roll(a, -1, axis=1)).cuda()))
    return out


def _p25_step(vg, batches):
    """``run_training``'s step: ``jit(value_and_grad(loss_fn))`` on the step's
    batch, then the port's bf16-true SGD in place. The state is the params
    and the step counter."""
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.parallel.train import sgd_update

    def p25_step(state):
        k = int(state["k"])
        ids, tgt = batches[k]
        loss, grads = vg(state["params"], ids, tgt)
        flat, _ = tree_flatten(state["params"])
        sgd_update(flat, list(grads), P25_LR, 0.0, in_place=True)
        return {"params": state["params"], "k": k + 1}, loss

    return p25_step


def _p25_vg(cfg, **options):
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    def loss_fn(p, i, t):
        return gpt.loss_fn(p, i, t, cfg)

    return tt.value_and_grad(loss_fn, **options)


def _timed_manager(directory: str, **kw):
    """A ``CheckpointManager`` that keeps the seconds of its last save and
    restore."""
    from thunder_tpu_torch.resilience import CheckpointManager

    class Timed(CheckpointManager):
        save_s = restore_s = None

        def save(self, *a, **k):
            t = time.perf_counter()
            out = super().save(*a, **k)
            self.save_s = time.perf_counter() - t
            return out

        def restore(self):
            t = time.perf_counter()
            out = super().restore()
            self.restore_s = time.perf_counter() - t
            return out

    return Timed(directory, backoff_s=0, **kw)


def _tree_bytes(tree) -> int:
    from thunder_tpu_torch.core.pytree import tree_flatten

    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _count_delta(before: dict, launches: dict) -> dict:
    after = _launch_counts()
    delta = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    for k, v in delta.items():
        launches[k] = launches.get(k, 0) + v
    return delta


def run_preempt_resume(cfg, batches, root: str, launches: dict) -> dict:
    """Phase 25 (a). ``run_training`` for P25_STEPS steps uninterrupted, then
    preempted at step 2 (the chaos ``preempt`` seam) into a checkpoint, then
    resumed by a fresh manager and a fresh jit: the losses and every final
    param bit-equal to the uninterrupted run's. Returns the uninterrupted
    run's losses and final params for (b)."""
    import os
    import shutil

    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.resilience import Preempted, chaos_scope, run_training

    before = _launch_counts()
    vg = _p25_vg(cfg)
    state = {"params": gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda"), "k": 0}
    nbytes = _tree_bytes(state["params"])
    t = time.perf_counter()
    final, losses = run_training(_p25_step(vg, batches), state, P25_STEPS,
                                 manager=_timed_manager(os.path.join(root, "uninterrupted")))
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    ref_params, ref_spec = tree_flatten(final["params"])
    del state, final

    free0 = shutil.disk_usage(root).free
    mgr = _timed_manager(os.path.join(root, "preempted"))
    state = {"params": gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda"), "k": 0}
    first = []
    with chaos_scope("preempt@2"):
        try:
            run_training(_p25_step(vg, batches), state, P25_STEPS, manager=mgr, on_loss=lambda k, x: first.append(x))
            stopped = None
        except Preempted as e:
            stopped = e.step
    free1 = shutil.disk_usage(root).free
    ckpt_bytes = _dir_bytes(mgr._step_dir(2)) if stopped == 2 else 0
    del state, vg
    gc.collect()
    torch.cuda.empty_cache()
    # A fresh "process": a new manager on the directory and a new jit; the
    # template only says where the restored leaves land.
    fresh = _timed_manager(os.path.join(root, "preempted"))
    template = {"params": _cuda_template(ref_spec, len(ref_params)), "k": 0}
    vg2 = _p25_vg(cfg)
    resumed, tail = run_training(_p25_step(vg2, batches), template, P25_STEPS, manager=fresh)
    torch.cuda.synchronize()
    got = tree_flatten(resumed["params"])[0]
    same_losses = [bool(torch.equal(a, b)) for a, b in zip(losses, first + tail)]
    unequal = sum(not torch.equal(a, b) for a, b in zip(ref_params, got))
    delta = _count_delta(before, launches)
    log(f"  (a) {cfg.n_layer} layers, params {nbytes / 1e9:.2f} GB: uninterrupted losses "
        f"{', '.join(f'{x.item():.6f}' for x in losses)} ({full_s:.1f} s); preempted at step {stopped}, then resumed "
        f"by a fresh manager and jit: {', '.join(f'{x.item():.6f}' for x in first + tail)}; bit-equal "
        f"{same_losses}; final params bit-equal {unequal == 0} ({unequal} of {len(got)} differ)")
    log(f"  (a) checkpoint of step {stopped}: {ckpt_bytes / 1e9:.3f} GB on disk, save {mgr.save_s:.2f} s "
        f"({ckpt_bytes / 1e9 / mgr.save_s:.2f} GB/s), restore {fresh.restore_s:.2f} s "
        f"({ckpt_bytes / 1e9 / fresh.restore_s:.2f} GB/s, warm: the file cache holds what was just written); "
        f"free disk {free0 / 1e9:.1f} GB before, {free1 / 1e9:.1f} GB after; launches {delta}")
    require(stopped == 2 and len(tail) == P25_STEPS - 2, f"the preempted run stopped at {stopped}")
    require(all(same_losses) and unequal == 0, "the resumed run differs from the uninterrupted one")
    del resumed, got, template, vg2
    shutil.rmtree(os.path.join(root, "preempted"), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "params": ref_params, "spec": ref_spec}


def _cuda_template(spec, n: int) -> dict:
    """The params' tree with an empty CUDA tensor a leaf: where a restore
    lands its leaves."""
    from thunder_tpu_torch.core.pytree import tree_unflatten

    return tree_unflatten([torch.empty(0, device="cuda") for _ in range(n)], spec)


def run_tiered_restore(cfg, batches, ref: dict, root: str, launches: dict) -> None:
    """Phase 25 (b). ``snapshot_every=1`` with a SnapshotStore, ``host_loss@3``:
    ``elastic_resume`` onto the same one-rank mesh wins from the RAM tier
    and the continued step is bit-equal; the snapshots' stall and copy
    rate."""
    import json as _json
    import os
    import shutil

    from thunder_tpu_torch.core.pytree import tree_flatten, tree_map
    from thunder_tpu_torch.distributed.runtime import P
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability import events as ev
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.resilience import HostLost, SnapshotStore, chaos_scope, elastic_resume, run_training

    before = _launch_counts()
    vg = _p25_vg(cfg)
    store = SnapshotStore(host=0, ring=2)
    mgr = _timed_manager(os.path.join(root, "tiered"), store=store)
    state = {"params": gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda"), "k": 0}
    nbytes = _tree_bytes(state["params"])
    log_path = os.path.join(root, "tiered.jsonl")
    ev.set_global_path(log_path)
    try:
        head = []
        with chaos_scope("host_loss@3"):
            try:
                run_training(_p25_step(vg, batches), state, P25_STEPS, manager=mgr, snapshot_every=1,
                             on_loss=lambda k, x: head.append(x))
                lost = None
            except HostLost as e:
                lost = e.step
        del state
        gc.collect()
        torch.cuda.empty_cache()
        mesh = make_mesh()
        template = {"params": _cuda_template(ref["spec"], len(ref["params"])), "k": 0}
        specs = {"params": tree_map(lambda _: P(), template["params"]), "k": P()}
        restored, start = elastic_resume(mgr, template, mesh=mesh, specs=specs)
        _, tail = run_training(_p25_step(vg, batches), restored, P25_STEPS,
                               manager=_timed_manager(os.path.join(root, "tiered-cont")), start_step=start)
        torch.cuda.synchronize()
    finally:
        ev.set_global_path(None)
    recs = [_json.loads(line) for line in open(log_path)]
    snaps = [r for r in recs if r["kind"] == "snapshot"]
    resume = next(r for r in recs if r["kind"] == "elastic_resume")
    got = tree_flatten(restored["params"])[0]
    same = [bool(torch.equal(a, b)) for a, b in zip(ref["losses"], head + tail)]
    unequal = sum(not torch.equal(a, b) for a, b in zip(ref["params"], got))
    delta = _count_delta(before, launches)
    stalls = [r["stall_ms"] for r in snaps]
    log(f"  (b) host loss at step {lost}; elastic_resume onto {mesh.shape} from tier {resume['tier']} at step "
        f"{start}; losses {', '.join(f'{x.item():.6f}' for x in head + tail)} bit-equal {same}; final params "
        f"bit-equal {unequal == 0}; launches {delta}")
    log(f"  (b) snapshots at steps {[r['step'] for r in snaps]}: stall_ms {stalls} (device -> pinned host, one "
        f"synchronize, and the crc32 of {nbytes / 1e9:.2f} GB), copy+crc rate "
        f"{[round(nbytes / 1e6 / ms, 2) for ms in stalls]} GB/s; the disk save at the host loss {mgr.save_s:.2f} s")
    require(lost == 3 and resume["tier"] == "local" and start == 3, f"tier {resume['tier']} at step {start}")
    require(all(same) and unequal == 0, "the RAM-tier resume differs from the uninterrupted run")
    del restored, got, store, mgr, vg
    shutil.rmtree(os.path.join(root, "tiered"), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def _ladder_under_cap(vg, params, ids, tgt, cap: int):
    """One call of ``vg`` with the caching allocator held to ``cap`` bytes
    (``set_per_process_memory_fraction``, restored to 1.0 after): the
    outcome (None when it returned, else the error's type), the loss and
    grads moved to the host, and ``memory_allocated`` once they have left
    the card."""
    total = torch.cuda.get_device_properties(0).total_memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        try:
            loss, grads = vg(params, ids, tgt)
            torch.cuda.synchronize()
            outcome = None
        except torch.OutOfMemoryError as e:
            loss = grads = None
            outcome = type(e).__name__
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
    if loss is not None:
        loss, grads = loss.cpu(), [g.cpu() for g in grads]
    gc.collect()
    torch.cuda.empty_cache()
    return outcome, loss, grads, torch.cuda.memory_allocated()


def run_deopt_oom(cfg, batches, root: str, launches: dict) -> None:
    """Phase 25 (c). A real ``torch.OutOfMemoryError`` under
    ``set_per_process_memory_fraction`` climbs the de-opt ladder. L2 is the
    joint program rematerialized (``rematerialize_joint``); a real failure
    skips a level that would compile the failing program again (L3 here: no
    buckets), so the levels climbed only need to rise. Two caps:

    - from ``predict_level_peaks``: between the lowest fitting level's
      prediction and L0's measured peak (allocated bytes). The planner's
      prediction is of allocated bytes, and the cap holds the allocator's
      reserved bytes, which fragmentation puts above them; so the ladder
      may recover there or end in the typed error, and the outcome is the
      reading;
    - from the allocator itself: between that level's measured reserved
      peak (the level forced, uncapped) and L0's. There the ladder must
      recover, with the uncapped step's loss and grads.

    When no level is predicted more than 8% below L0 (the planner's
    measured error), the cap goes under every level and the typed error of
    the exhausted ladder is the finding. After every run
    ``memory_allocated`` is a fresh compile's."""
    import json as _json
    import os

    from thunder_tpu_torch.analysis.liveness import predict_level_peaks
    from thunder_tpu_torch.models import gpt

    import thunder_tpu_torch as tt

    small = replace(cfg, n_layer=P25_OOM_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(small, dtype=torch.bfloat16, seed=SEED, device="cuda")
    ids, tgt = batches[0]
    base = torch.cuda.memory_allocated()
    before = _launch_counts()

    def peak_of(level=None):
        vg = _p25_vg(small)
        if level is not None:
            vg._lc_cd._deopt_level = level
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = vg(params, ids, tgt)
        torch.cuda.synchronize()
        # Kept on the host: on the card they would shrink the room that a
        # capped run has beside the params and batch, which the predictions
        # count.
        return (vg, loss.cpu(), [g.cpu() for g in grads], torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved())

    vg0, l0, g0, measured, measured_res = peak_of()
    peaks = predict_level_peaks(tt.last_traces(vg0)[-1])
    del vg0
    gc.collect()
    torch.cuda.empty_cache()
    fresh = torch.cuda.memory_allocated()
    fits = [lv for lv in (1, 2, 3) if peaks[lv] < peaks[0] * 0.92]
    log(f"  (c) {small.n_layer} layers: L0 measured peak {measured / 2**30:.3f} GiB allocated, "
        f"{measured_res / 2**30:.3f} reserved; predicted per level "
        f"{ {k: round(v / 2**30, 3) for k, v in peaks.items()} } GiB")
    caps = []
    if fits:
        lf = min(fits)
        vgf, lf_loss, lf_grads, lf_alloc, lf_res = peak_of(lf)
        remat = tt.last_traces(vgf)[-1].tags.get("remat_joint")
        same = torch.equal(lf_loss, l0) and all(torch.equal(a, b) for a, b in zip(lf_grads, g0))
        log(f"  (c) L{lf} forced, uncapped: peak {lf_alloc / 2**30:.3f} GiB allocated (predicted "
            f"{peaks[lf] / 2**30:.3f}), {lf_res / 2**30:.3f} reserved; joint remat {remat}; loss and grads "
            f"bit-equal to L0's {same}")
        del vgf, lf_loss, lf_grads
        caps.append(("predicted", (peaks[lf] + measured) // 2,
                     f"between L{lf}'s prediction and L0's measured allocated peak"))
        if lf_res < measured_res * 0.92:
            caps.append(("reserved", (lf_res + measured_res) // 2,
                         f"between L{lf}'s and L0's measured reserved peaks"))
        else:
            log(f"  (c) L{lf}'s reserved peak is not 8% under L0's: no cap between them")
    else:
        caps.append(("under every level", (peaks[0] + measured) // 2 if peaks[0] < measured else int(measured * 0.9),
                     "under every level (no level is predicted more than 8% below L0)"))
    total = torch.cuda.get_device_properties(0).total_memory
    for name, cap, case in caps:
        log_path = os.path.join(root, f"deopt-{name.replace(' ', '-')}.jsonl")
        vg = _p25_vg(small, events=log_path)
        outcome, l1, g1, after = _ladder_under_cap(vg, params, ids, tgt, cap)
        deopts = [r for r in (_json.loads(line) for line in open(log_path)) if r["kind"] == "compile_deopt"]
        info = tt.cache_info(vg)
        log(f"  (c) cap {cap / 2**30:.3f} GiB ({case}), fraction {cap / total:.4f}:")
        for r in deopts:
            log(f"  (c)   compile_deopt level {r['level']} ({r['action']}), reason {r['reason']!r}, attempt "
                f"{r['attempt']}, predicted_peak_bytes {r.get('predicted_peak_bytes')}, capacity_bytes "
                f"{r.get('capacity_bytes')}, skipped_levels {r.get('skipped_levels')}, repeated_levels "
                f"{r.get('repeated_levels')}")
        remat = tt.last_traces(vg)[-1].tags.get("remat_joint") if outcome is None else None
        log(f"  (c)   outcome: {outcome or 'recovered'} at ladder level {info['degradation_level']} (joint remat "
            f"{remat}); memory_allocated after {after / 2**30:.4f} GiB, a fresh compile's {fresh / 2**30:.4f} GiB "
            f"(params and batch {base / 2**30:.4f})")
        levels = [r["level"] for r in deopts]
        require(levels and levels == sorted(set(levels)), f"levels {deopts}")
        require(after == fresh, f"memory_allocated {after} after the ladder, {fresh} after a fresh compile")
        if outcome is None:
            require(info["degradation_level"] < 2 or (remat and remat["recomputed"] > 0),
                    f"level {info['degradation_level']} ran without the joint remat")
            same = torch.equal(l1, l0) and all(torch.equal(a, b) for a, b in zip(g1, g0))
            worst = max(float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30))
                        for a, b in zip(g1, g0))
            log(f"  (c)   the recovered step against the uncapped one: bit-equal {same}; worst grad rel {worst:.3e}")
            require(same or worst <= 2.0 ** -7, "the recovered step differs from the uncapped one")
        else:
            require(outcome == "OutOfMemoryError", f"the exhausted ladder gave {outcome}")
        require(name != "reserved" or outcome is None, f"the ladder did not recover under {case}: {outcome}")
        require(name != "under every level" or outcome is not None, "the step fit under every level's cap")
        del vg, l1, g1
    log(f"  (c) launches {_count_delta(before, launches)}")
    del params, g0
    gc.collect()
    torch.cuda.empty_cache()


def run_demotion(cfg, launches: dict) -> None:
    """Phase 25 (d). ``kernel_raise`` on the flash wrapper: the first call
    demotes loudly and its entry launches rows 6-7 zero times, its loss
    within phase 4's flash-against-torch limit of the undemoted loss and
    equal to the fused and torch executors' (the default less flash); after
    ``clear_quarantine`` a recompile launches the flash kernels again."""
    import json as _json
    import logging
    import os
    import shutil
    import tempfile

    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.resilience import clear_quarantine, quarantine_snapshot

    two = replace(cfg, n_layer=2)
    params = gpt.init_params(two, dtype=torch.bfloat16, seed=SEED, device="cuda")
    gen = np.random.RandomState(SEED)
    a = gen.randint(0, two.vocab_size, (LOSS_BATCH, SEQ))
    ids, tgt = torch.from_numpy(a).cuda(), torch.from_numpy(np.roll(a, -1, axis=1)).cuda()
    kernels = ("flash_fwd_lse", "flash_bwd")
    want = float(_p25_vg(two)(params, ids, tgt)[0])
    # The default executors less flash: the program the demoted entry runs.
    fused_loss = _p25_vg(two, executors=["fused", "torch"])(params, ids, tgt)[0]

    class Grab(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())

    grab = Grab()
    logger = logging.getLogger("thunder_tpu_torch")
    logger.addHandler(grab)
    log_path = os.path.join(tempfile.mkdtemp(), "demote.jsonl")
    try:
        vg = _p25_vg(two, chaos="kernel_raise@flash*1", events=log_path)
        before = _launch_counts()
        losses = [vg(params, ids, tgt)[0] for _ in range(3)]  # the demoted entry: eager, capture, replay
        torch.cuda.synchronize()
        delta = _count_delta(before, launches)
    finally:
        logger.removeHandler(grab)
    events = [r for r in (_json.loads(line) for line in open(log_path)) if r["kind"] in ("fault_injected",
                                                                                       "executor_demoted")]
    shutil.rmtree(os.path.dirname(log_path), ignore_errors=True)
    quarantined = sorted(f"{s}:{e}" for s, e in quarantine_snapshot())
    rel = abs(float(losses[0]) - want) / abs(want)
    log(f"  (d) WARNING lines: {grab.msgs}")
    log(f"  (d) events: {[(r['kind'], r.get('sym') or r.get('target'), r.get('executor')) for r in events]}; "
        f"quarantined {quarantined}")
    log(f"  (d) demoted loss {float(losses[0]):.6f} (3 calls bit-equal {all(torch.equal(x, losses[0]) for x in losses)}; "
        f"fused and torch executors {float(fused_loss):.6f}, bit-equal {bool(torch.equal(losses[0], fused_loss))}), "
        f"undemoted {want:.6f}, rel {rel:.3e} (phase 4's limit {LOSS_REL:.0e}); launches of rows 6-7 over the 3 calls "
        f"{ {k: delta.get(k, 0) for k in kernels} }")
    require(grab.msgs and any("flash" in m for m in grab.msgs), "the demotion logged no WARNING")
    require([r["kind"] for r in events][:2] == ["fault_injected", "executor_demoted"], f"events {events}")
    require(all(delta.get(k, 0) == 0 for k in kernels), f"the demoted entry launched {delta}")
    require(rel <= LOSS_REL and bool(torch.equal(losses[0], fused_loss)), "the demoted loss")
    clear_quarantine()
    before = _launch_counts()
    again = _p25_vg(two)
    back = float(again(params, ids, tgt)[0])
    delta = _count_delta(before, launches)
    log(f"  (d) after clear_quarantine(): a recompile launches {({k: delta.get(k, 0) for k in kernels})}, loss "
        f"{back:.6f} (undemoted {want:.6f})")
    require(all(delta.get(k, 0) == two.n_layer for k in kernels) and back == want, "flash did not come back")
    del params, vg, again
    gc.collect()
    torch.cuda.empty_cache()


def run_nan_guard(cfg, batches, launches: dict) -> None:
    """Phase 25 (e). The isfinite guard's cost on the clean staged step
    (``on_nan=None`` against ``"raise"``, device and wall ms over
    NAN_GUARD_CALLS calls, in turns), then a ``nan`` on one line under
    ``"rerun-instrumented"`` naming that line's symbol, at 2 layers."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.resilience import NonFiniteOutputError

    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda")
    ids, tgt = batches[0]
    before = _launch_counts()
    plain, guarded = _p25_vg(cfg), _p25_vg(cfg, on_nan="raise")
    n_grads = len(plain(params, ids, tgt)[1])
    guarded(params, ids, tgt)
    for f in (plain, guarded):
        f(params, ids, tgt)  # the capture
    torch.cuda.synchronize()

    def timed(f):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(NAN_GUARD_CALLS):
            f(params, ids, tgt)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / NAN_GUARD_CALLS, (time.perf_counter() - t) * 1e3 / NAN_GUARD_CALLS

    rounds = [(timed(plain), timed(guarded)) for _ in range(2)]
    staged = (tt.last_staging(plain).staged, tt.last_staging(guarded).staged)
    split = {}
    for name, f in (("off", plain), ("raise", guarded)):
        split[name] = sum(kernel_split_us(lambda f=f: f(params, ids, tgt), calls=3).values()) / 1e3
    delta = _count_delta(before, launches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"  (e) {cfg.n_layer} layers on {smi}, staged {staged}, {n_grads} grads + the loss checked: "
        + "; ".join(f"round {i + 1}: on_nan=None {a[0]:.2f} ms event-timed, {a[1]:.2f} ms wall; 'raise' "
                    f"{b[0]:.2f} ms, {b[1]:.2f} ms wall" for i, (a, b) in enumerate(rounds))
        + f"; device busy (profiler, kernels only) off {split['off']:.2f} ms, raise {split['raise']:.2f} ms a call; "
        f"launches {delta}")
    require(all(staged), "a step is not staged")
    del plain, guarded, params
    gc.collect()
    torch.cuda.empty_cache()

    two = replace(cfg, n_layer=2)
    p2 = gpt.init_params(two, dtype=torch.bfloat16, seed=SEED, device="cuda")
    probe = _p25_vg(two)
    probe(p2, ids, tgt)
    claimed = tt.last_traces(probe)[-2]
    i, target = next((i, b) for i, b in enumerate(claimed.bound_symbols) if b.sym.name == "sdpa_fwd_res")
    out_name = target.flat_proxy_outs[0].name
    vg = _p25_vg(two, chaos=f"nan@L{i}*1", on_nan="rerun-instrumented")
    try:
        vg(p2, ids, tgt)
        err = None
    except NonFiniteOutputError as e:
        err = e
    log(f"  (e) nan on line L{i} ({target.sym.name}, output {out_name}) under 'rerun-instrumented': "
        f"{type(err).__name__ if err else 'no error'}: symbol {err and err.symbol!r}, line {err and err.line!r}, "
        f"provenance {err and err.provenance!r}")
    require(err is not None and err.symbol == "chaos_nan_poison" and f"chaos_nan_poison({out_name})" in err.line,
            "the NaN guard did not name the poisoned line")
    del p2, probe, vg
    gc.collect()
    torch.cuda.empty_cache()


P25_WATCHDOG_LAYERS = 2


def _hang_under_watchdog(label: str, call, want_lines, staging=None):
    """One call of ``call()`` under a 2 s watchdog (``monitor.
    configure_watchdog``) and ``collective_hang~3.0`` (a 3 s sleep inside the
    guarded region): the ``CollectiveTimeoutError`` it raises, the seconds to
    it, and the replays the abandoned worker ran once it woke: none, as a
    hung collective never completes. Then the watchdog is turned off
    again."""
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.resilience import CollectiveTimeoutError, chaos_scope, watchdog

    replays = staging.replays if staging is not None else None
    monitor.configure_watchdog(2.0)
    t = time.perf_counter()
    try:
        with chaos_scope("collective_hang~3.0"):
            call()
        err = None
    except CollectiveTimeoutError as e:
        err = e
    finally:
        elapsed = time.perf_counter() - t
        monitor.configure_watchdog(None)
    for worker in list(watchdog._abandoned):
        worker.join(timeout=60)
    torch.cuda.synchronize()
    ran = None if staging is None else staging.replays - replays
    lines = list(err.trace_lines) if err is not None else None
    log(f"  (f) {label}: {type(err).__name__ if err else 'no error'} after {elapsed:.2f} s naming {lines}; the "
        f"program's own collective lines {list(want_lines)}; replays run by the abandoned worker {ran}")
    require(err is not None and elapsed < 2.9, f"{label}: the watchdog did not fire within its timeout")
    require(want_lines and lines == list(want_lines), f"{label}: the error names {lines}, not {list(want_lines)}")
    require(staging is None or ran == 0, f"{label}: the abandoned worker ran {ran} replays, not 0")


def run_watchdog(cfg, batches, launches: dict) -> None:
    """Phase 25 (f), at one NCCL rank, through the two dispatch sites the
    watchdog guards. (1) ``jit``: open_llama_3b's ddp step as one
    ``value_and_grad`` program, every param through ``synchronize`` over
    dp (its backward all-reduces the grad), staged; under the watchdog the
    staged replay runs on a worker thread on the caller's stream, and the
    error names the entry's own collective lines. The next unguarded call
    gives the loss and grads of the same step with no collectives, bit for
    bit (at one rank the average divides by 1). (2)
    ``distributed/runtime.shard_map_callable``: the all-reduce of a
    (hidden, intermediate) bf16 grad, staged; the error names the
    callable's ``trace_lines``; the next call gives its one-rank value."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.distributed as td
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.prims import collective_trace_lines
    from thunder_tpu_torch.distributed.runtime import P, bound_axes, compile_with_collectives, resolve_axes
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import make_mesh

    small = replace(cfg, n_layer=P25_WATCHDOG_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    params = gpt.init_params(small, dtype=torch.bfloat16, seed=SEED, device="cuda")
    ids, tgt = batches[0]

    def ddp_loss(p, i, t):
        flat, spec = tree_flatten(p)
        return gpt.loss_fn(tree_unflatten(spec, [dist.synchronize(w, "dp", 1, "replicated") for w in flat]), i, t,
                           small)

    before = _launch_counts()
    dist_init()
    try:
        ddp = tt.value_and_grad(ddp_loss)
        plain = _p25_vg(small)
        with bound_axes(resolve_axes(make_mesh(dp=1), ["dp"])):
            want_l, want_g = plain(params, ids, tgt)
            want_g = [g.clone() for g in tree_flatten(want_g)[0]]
            for _ in range(3):  # warm-up, capture, replay
                ddp(params, ids, tgt)
            torch.cuda.synchronize()
            st = tt.last_staging(ddp)
            lines = collective_trace_lines(tt.last_traces(ddp)[-1])
            log(f"  (f) jit: the ddp step of {small.n_layer} layers staged {st.staged} (captures {st.captures}, "
                f"replays {st.replays}); {len(collective_trace_lines(tt.last_traces(ddp)[-1], limit=10**6))} "
                f"collective lines")
            require(st.staged and st.replays >= 1, "the ddp step is not staged")
            _hang_under_watchdog("jit", lambda: ddp(params, ids, tgt), lines, st)
            got_l, got_g = ddp(params, ids, tgt)
            torch.cuda.synchronize()
            same = torch.equal(got_l, want_l) and all(torch.equal(a, b)
                                                      for a, b in zip(tree_flatten(got_g)[0], want_g))
            log(f"  (f) jit: the next unguarded call's loss {got_l.item():.6f}, the step with no collectives "
                f"{want_l.item():.6f}; loss and {len(want_g)} grads bit-equal {same}")
            require(same, "the ddp step after the hang differs from the step with no collectives")
            del got_g, want_g, ddp, plain
        grad = torch.randn((OPEN_LLAMA_3B.hidden_size, OPEN_LLAMA_3B.intermediate_size),
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 25), device="cuda"
                           ).to(torch.bfloat16)
        jf, _ = compile_with_collectives(lambda a: dist.all_reduce(a, "dp", 1), (grad,), None, (P(),), P())
        for _ in range(3):
            jf(grad)
        torch.cuda.synchronize()
        _hang_under_watchdog("shard_map_callable", lambda: jf(grad), jf.trace_lines, jf.staging)
        out = jf(grad)
        torch.cuda.synchronize()
        log(f"  (f) shard_map_callable: the next call equals its one-rank value {torch.equal(out, grad)}")
        require(torch.equal(out, grad), "the all-reduce after the hang differs from its one-rank value")
        del jf, out, grad
    finally:
        gc.collect()
        torch.cuda.synchronize()
        td.shutdown()
    require(not td.is_initialized(), "the process group outlived phase 25 (f)")
    log(f"  (f) launches {_count_delta(before, launches)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def run_resilience(cfg, launches: dict) -> None:
    """Phase 25 (a)-(f)."""
    import shutil
    import tempfile

    batches = _p25_batches(cfg.vocab_size)
    root = tempfile.mkdtemp(prefix="phase25-")
    try:
        free = shutil.disk_usage(root).free
        need = 4 * 7e9
        full = cfg if free > need else replace(cfg, n_layer=max(2, int(cfg.n_layer * free / need)))
        if full is not cfg:
            log(f"  only {free / 1e9:.1f} GB of disk free: (a)-(b) run at {full.n_layer} layers, full width")
        t = time.perf_counter()
        ref = run_preempt_resume(full, batches, root, launches)
        log(f"  (a) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_tiered_restore(full, batches, ref, root, launches)
        log(f"  (b) took {time.perf_counter() - t:.1f} s")
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        run_deopt_oom(cfg, batches, root, launches)
        log(f"  (c) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_demotion(cfg, launches)
        log(f"  (d) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_nan_guard(cfg, batches, launches)
        log(f"  (e) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_watchdog(cfg, batches, launches)
        log(f"  (f) took {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# =============================================================================
# Phase 26: the fleet layer (resilience/autopilot.py, resilience/federation.py,
# observability/opsplane.py)
# =============================================================================

# The depths of (a) and (c), cut from the model's 26 (width kept) to fit the
# phase's share of the call: every run here writes a disk anchor of the
# whole state and a RAM snapshot a step, whose cost grows with the depth.
P26_LAYERS = 4
P26_FED_LAYERS = 2
P26_STEPS = 4
P26_FED_STEPS = 7
P26_LR = 1e-4
P26_WATCHDOG_S = 2.0
# The hang outlives the watchdog by long enough that its abandoned worker is
# still asleep when /healthz is read after the resume.
P26_HANG_S = 8.0
OPS_HIT_OVERHEAD = 1.05  # a staged hit with the plane armed against off
OPS_DEVICE_REL = 0.01  # the step's device ms armed against off
FED_LOSS_RTOL = 1e-2  # bf16: width 1's two B=1 micro-steps against one B=2 call


def _p26_batches(vocab: int, n: int, seed: int) -> list:
    gen = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = gen.randint(0, vocab, (LOSS_BATCH, SEQ))
        out.append((torch.from_numpy(a).cuda(), torch.from_numpy(np.roll(a, -1, axis=1)).cuda()))
    return out


def _p26_step(cfg, mesh, batches):
    """``build_train_step`` (SGD, not donating: the driver's warm-up step
    and the snapshots read a state no step updates) on the one-rank mesh,
    as ``run_training``'s ``step(state) -> (state, loss)``: step k reads
    batch k, the data order a resumed run restores."""
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step

    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=SEED, device="cuda")
    step, opt = build_train_step(cfg, params, *batches[0], mesh=mesh, optimizer="sgd", lr=P26_LR, donate=False)

    def p26_step(state):
        k = int(state["k"])
        p, o, loss = step(state["params"], state["opt"], *batches[k])
        return {"params": p, "opt": o, "k": k + 1}, loss

    return p26_step, {"params": params, "opt": opt, "k": 0}


def _http(port: int, route: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _drive(step_fn, state, root: str, name: str, *, spec: str = "", on_step=None, store=True):
    """``run_autopiloted_training`` of ``step_fn`` for P26_STEPS steps on the
    one-rank mesh under ``spec``, the watchdog at P26_WATCHDOG_S and, with
    ``store``, a RAM snapshot a step: ``(state, report, autopilot,
    manager)``."""
    import os

    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.resilience import Autopilot, SnapshotStore, chaos_scope, run_autopiloted_training

    mgr = _timed_manager(os.path.join(root, name), store=SnapshotStore() if store else None)
    ap = Autopilot()
    with chaos_scope(spec):
        state, report = run_autopiloted_training(
            ap, lambda m: step_fn, state, P26_STEPS, manager=mgr, mesh=make_mesh(dp=1),
            specs_for_mesh=lambda m: None, sdc_guard=False, watchdog_timeout_s=P26_WATCHDOG_S,
            snapshot_every=1 if store else 0, on_step=on_step)
    return state, report, ap, mgr


def run_autopilot(cfg, root: str, plane, launches: dict) -> dict:
    """Phase 26 (a) and (b). Under one event log, metrics on, the ops plane
    armed: (1) ``oom*1`` at the first call of a staged ``value_and_grad``:
    the autopilot's deopt_escalate decision, then its compile_deopt; (2)
    the autopiloted run with no fault; (3) the same under a collective hang
    planted at step 2: one same-mesh elastic_resume from the RAM tier, the
    losses bit-equal to (2)'s, the four endpoints read over HTTP during the
    run (/healthz degraded by the abandoned worker); (4) ``preempt@3``: a
    checkpoint_halt decision and AutopilotHalt, then a fresh manager and a
    fresh step resume from disk to the end, bit-equal. The log replays with
    no unrecovered fault and no unactuated decision; AUTOPILOT_DECISIONS
    counts every decision; the recorder left one collective_timeout and one
    autopilot_halt dump, each replaying schema-valid. Returns the staged
    ``value_and_grad`` and its inputs for the plane's overhead readings."""
    import glob
    import os

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.analysis import events as ev_replay
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability import metrics as obsm
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.resilience import Autopilot, AutopilotHalt, chaos

    small = replace(cfg, n_layer=P26_LAYERS)
    batches = _p26_batches(small.vocab_size, P26_STEPS, SEED + 26)
    log_path = os.path.join(root, "events.jsonl")
    before = _launch_counts()
    monitor.reset()
    monitor.enable()
    monitor.set_event_log(log_path)
    try:
        # (1) the de-opt climb as a decision.
        params = gpt.init_params(small, dtype=torch.bfloat16, seed=SEED, device="cuda")
        vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, small), chaos="oom*1")
        ap = Autopilot()
        with ap.installed():
            for _ in range(3):  # the recovered first call, the capture, a replay
                out = vg(params, *batches[0])
        torch.cuda.synchronize()
        del out
        level = tt.cache_info(vg)["entries"][0]["degradation_level"]
        recs = [json.loads(line) for line in open(log_path)]
        order = [(r["kind"], r.get("actuator")) for r in recs if r["kind"] in ("autopilot_decision", "compile_deopt")]
        log(f"  (a) oom*1 at the first call of the staged value_and_grad, {small.n_layer} layers: decisions "
            f"{[(d.signal.kind, d.actuator) for d in ap.decisions]}; events in order {order}; the entry's de-opt "
            f"level {level}, staged {tt.last_staging(vg).staged}")
        require(order == [("autopilot_decision", "deopt_escalate"), ("compile_deopt", None)] and level == 1,
                "the de-opt climb was not the autopilot's decision before its compile_deopt")

        # (2) the run with no fault, (3) the same with a hang at step 2.
        step_fn, state0 = _p26_step(small, make_mesh(dp=1), batches)
        t = time.perf_counter()
        _, base, base_ap, _ = _drive(step_fn, state0, root, "base")
        base_s = time.perf_counter() - t
        require(base.halted is None and not base_ap.decisions, "the run with no fault decided something")
        seen = {}

        def hang_at_2(step, loss):
            if step == 1:
                chaos.active().rules.append(chaos.FaultRule("collective_hang", delay_s=P26_HANG_S))
            elif step == 2 and "healthz" not in seen:
                for route in ("/healthz", "/metrics", "/debug/state", "/debug/flightrec"):
                    seen[route.strip("/").replace("debug/", "")] = _http(plane.port, route)

        t = time.perf_counter()
        _, hung, _, _ = _drive(step_fn, state0, root, "hang", on_step=hang_at_2)
        hung_s = time.perf_counter() - t
        recs = [json.loads(line) for line in open(log_path)]
        resume = [r for r in recs if r["kind"] == "elastic_resume"]
        same = [bool(torch.equal(a, b)) for a, b in zip(base.losses, hung.losses)]
        log(f"  (a) the autopiloted run, {P26_STEPS} steps, watchdog {P26_WATCHDOG_S} s, a snapshot a step: no fault "
            f"{base_s:.1f} s, losses {', '.join(f'{x.item():.6f}' for x in base.losses)}; collective_hang "
            f"~{P26_HANG_S} s at step 2 {hung_s:.1f} s: decisions "
            f"{[(d.signal.kind, d.actuator, d.mode) for d in hung.decisions]}, resume tiers "
            f"{[(r['step'], r['tier']) for r in resume[-1:]]}; losses bit-equal {same}")
        require([(d.actuator, d.mode) for d in hung.decisions] == [("elastic_resume", "same_mesh")],
                "the hang did not give one same-mesh elastic_resume")
        require(resume and resume[-1]["tier"] == "local" and resume[-1]["step"] == 2,
                "the hang's resume did not come from the RAM tier at step 2")
        require(all(same) and len(same) == P26_STEPS, "the resumed run differs from the run with no fault")
        hz = json.loads(seen["healthz"][1])
        st = json.loads(seen["state"][1])
        fr = json.loads(seen["flightrec"][1])
        vg_state = [f for f in st["cache"] if f["fn"] == "<lambda>" and 1 in f["entry_degradation_levels"]]
        log(f"  (b) during the resumed run: /healthz {seen['healthz'][0]} {hz['status']} (watchdog "
            f"{hz['components']['watchdog']}, deopt {hz['components']['deopt']}); /metrics {seen['metrics'][0]} "
            f"({len(seen['metrics'][1].splitlines())} lines); /debug/state {seen['state'][0]}: {len(st['cache'])} live "
            f"functions, the staged value_and_grad's entry_degradation_levels "
            f"{[f['entry_degradation_levels'] for f in vg_state]}, autopilot decisions "
            f"{[d['actuator'] for d in (st['autopilot'] or {}).get('decisions', [])]}; /debug/flightrec "
            f"{seen['flightrec'][0]} ({fr['records']} records)")
        require(all(code == 200 for code, _ in seen.values()), f"an endpoint failed: {[c for c, _ in seen.values()]}")
        require(hz["status"] == "degraded" and hz["components"]["watchdog"]["status"] == "degraded",
                "/healthz did not read degraded after the watchdog timeout")
        require(vg_state and st["autopilot"] is not None, "/debug/state misses the de-opted step or the autopilot")
        require("thunder_tpu_autopilot_decisions_total" in seen["metrics"][1], "/metrics has no decision counter")

        # (4) preempt@3: halt, then a fresh manager and step resume from disk.
        try:
            _drive(step_fn, state0, root, "preempt", spec="preempt@3", store=False)
            halt = None
        except AutopilotHalt as e:
            halt = e
        del step_fn, state0
        gc.collect()
        torch.cuda.empty_cache()
        fresh_step, fresh0 = _p26_step(small, make_mesh(dp=1), batches)
        flat, spec = tree_flatten(fresh0["params"])
        fresh0 = {"params": _cuda_template(spec, len(flat)), "opt": fresh0["opt"], "k": 0}
        t = time.perf_counter()
        _, tail, _, tail_mgr = _drive(fresh_step, fresh0, root, "preempt", store=False)
        tail_s = time.perf_counter() - t
        same = [bool(torch.equal(a, b)) for a, b in zip(base.losses[3:], tail.losses[3:])]
        log(f"  (a) preempt@3: {type(halt).__name__ if halt else 'no halt'} at step {halt.step if halt else None}, "
            f"decisions {[(d.signal.kind, d.actuator) for d in halt.report.decisions] if halt else None}; a fresh "
            f"manager and step resumed from disk (restore {tail_mgr.restore_s:.2f} s) and ran steps 3-"
            f"{P26_STEPS - 1} in {tail_s:.1f} s, bit-equal {same}")
        require(halt is not None and halt.step == 3
                and [d.actuator for d in halt.report.decisions] == ["checkpoint_halt"], "preempt@3 did not halt")
        require(tail.losses[:3] == [None] * 3 and all(same) and len(same) == P26_STEPS - 3,
                "the resumed run after the halt differs from the run with no fault")
    finally:
        monitor.set_event_log(None)
    summary, diags = ev_replay.replay_events(log_path, storm_threshold=64)
    decided = {"deopt_escalate": 1, "elastic_resume": 1, "checkpoint_halt": 1}
    counted = {a: obsm.AUTOPILOT_DECISIONS.value(actuator=a) for a in decided}
    monitor.disable()
    log(f"  (a) the log replayed: autopilot decisions {summary['autopilot_decisions']}, unactuated "
        f"{summary['unactuated_decisions']}, faults {summary['faults_injected']}, unrecovered "
        f"{summary['unrecovered_faults']}, errors {[d.rule for d in diags if d.severity.name == 'ERROR']}; "
        f"AUTOPILOT_DECISIONS {counted}")
    require(summary["autopilot_decisions"] == decided and not summary["unactuated_decisions"]
            and not summary["unrecovered_faults"] and not any(d.severity.name == "ERROR" for d in diags),
            "the phase's event log does not replay clean")
    require(counted == decided, "AUTOPILOT_DECISIONS does not count each decision")
    dumps = {}
    for reason in ("collective_timeout", "autopilot_halt"):
        paths = glob.glob(os.path.join(root, "flightrec", f"flightrec-*-{reason}.jsonl"))
        findings = [ev_replay.replay_events(p) for p in paths]
        dumps[reason] = [(s["lines"], s["flightrec_dumps"], [d.rule for d in ds if d.severity.name == "ERROR"])
                         for s, ds in findings]
    log(f"  (b) flight-recorder dumps (records, trailers, replay errors): {dumps}")
    require(all(len(v) == 1 and v[0][1] == 1 and not v[0][2] for v in dumps.values()),
            "the recorder did not leave one schema-valid dump per fault")
    log(f"  (a) launches {_count_delta(before, launches)}")
    return {"vg": vg, "params": params, "batch": batches[0]}


def _device_ms(fn, iters: int) -> float:
    """The card's ms a call of ``fn`` over ``iters`` calls back to back
    between two CUDA events: for a call the card takes far longer to run
    than the host to enqueue (a training step), the host stays ahead."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def run_plane_overhead(plane, cfg, vg, params, batch) -> None:
    """Phase 26 (b), the plane's cost: the host µs of a cache hit of the
    staged forward loss at P26_LAYERS (its card time is the wait of each
    sample) with the plane armed and with it off (its event taps
    uninstalled), HIT_SAMPLES each in turns, the medians held within
    OPS_HIT_OVERHEAD; the staged step's device ms (CUDA events around 20
    replays) armed and off in turns (off, on, on, off), held within
    OPS_DEVICE_REL."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability import events

    taps, rec = events.ops_taps()

    def arm(on: bool) -> None:
        events.set_ops_taps(taps if on else (), recorder=rec if on else None)

    small = replace(cfg, n_layer=P26_LAYERS)
    loss = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, small))
    for _ in range(3):  # warm-up, capture, replay
        loss(params, *batch)

    def hit_us() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss(params, *batch)
        dt = (time.perf_counter() - t) * 1e6
        torch.cuda.synchronize()
        return dt

    off, on = [], []
    try:
        for _ in range(HIT_ROUNDS):
            arm(False)
            off.append(hit_us())
            arm(True)
            on.append(hit_us())
        dev = {False: [], True: []}
        for armed in (False, True, True, False):
            arm(armed)
            dev[armed].append(_device_ms(lambda: vg(params, *batch), 20))
    finally:
        arm(True)
    m_off, m_on = _median(off), _median(on)
    d_off, d_on = float(np.mean(dev[False])), float(np.mean(dev[True]))
    log(f"  (b) a staged hit of the forward loss, host µs to return: plane off median {m_off:.1f} (p10 "
        f"{np.percentile(off, 10):.1f}, p90 {np.percentile(off, 90):.1f}), armed median {m_on:.1f} (p10 "
        f"{np.percentile(on, 10):.1f}, p90 {np.percentile(on, 90):.1f}) over {len(off)} hits each: "
        f"{m_on / m_off:.4f}x; the staged value_and_grad step's device ms off {dev[False]}, armed {dev[True]}: "
        f"{d_on / d_off:.4f}x")
    require(m_on <= OPS_HIT_OVERHEAD * m_off, f"the armed plane cost {m_on / m_off:.4f}x a staged hit")
    require(abs(d_on / d_off - 1.0) <= OPS_DEVICE_REL, f"the armed plane moved the step's device ms {d_on / d_off:.4f}x")
    require(plane.server is not None and events.ops_active(), "the plane is not armed after the readings")


def run_federation(cfg, root: str) -> None:
    """Phase 26 (c). ``run_federated_training`` over 2 emulated slices of
    one rank each (the one-rank mesh at every width): ``build_for_width``
    runs ``accum`` micro-steps of a staged ``value_and_grad``, so the global
    batch stays two rows of SEQ: one B=2 call at width 2, two B=1 calls with
    their grads averaged at width 1; then bf16-true SGD. Under
    ``slice_loss@2,slice=1`` and ``recover_after=3``: decisions shrink_dp
    then regrow_dp, the shrink's restore from the buddy's RAM
    (``tier="peer"``) and no disk read after the anchor, the losses within
    FED_LOSS_RTOL of the full-width run's on the same tokens, a clean
    replay; the peer-tier restore seconds (the shrink decision to its
    elastic_resume event)."""
    import os

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.analysis import events as ev_replay
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.parallel.train import sgd_update
    from thunder_tpu_torch.resilience import (
        Autopilot,
        CheckpointManager,
        FederationLedger,
        FleetController,
        SnapshotStore,
        chaos_scope,
        run_federated_training,
    )
    from thunder_tpu_torch.resilience.federation import install_ledger

    small = replace(cfg, n_layer=P26_FED_LAYERS)
    batches = _p26_batches(small.vocab_size, P26_FED_STEPS, SEED + 261)
    vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, small))
    widths = []

    def build_for_width(mesh, width, accum):
        rows = LOSS_BATCH // accum

        def fed_step(state):
            k = int(state["k"])
            ids, tgt = batches[k]
            losses, grads = [], None
            for j in range(accum):
                loss, g = vg(state["params"], ids[j * rows:(j + 1) * rows], tgt[j * rows:(j + 1) * rows])
                g = tree_flatten(g)[0]
                losses.append(loss)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            if accum > 1:
                grads = [x / accum for x in grads]
            flat, spec = tree_flatten(state["params"])
            new = sgd_update(flat, grads, P26_LR, 0.0, in_place=False)
            return {"params": tree_unflatten(new, spec), "k": k + 1}, sum(losses) / accum

        return fed_step

    def run(name: str, spec: str):
        ledger = FederationLedger(2)
        fc = FleetController(ledger, Autopilot(), rejoin_backoff_s=0.0, hysteresis_s=0.0)
        stores = [SnapshotStore(host=i, ring=2) for i in range(2)]
        SnapshotStore.make_ring(stores)
        mgr = CheckpointManager(os.path.join(root, name), store=stores[0], backoff_s=0)
        state = {"params": gpt.init_params(small, dtype=torch.bfloat16, seed=SEED, device="cuda"), "k": 0}
        log_path = os.path.join(root, f"{name}.jsonl")
        monitor.set_event_log(log_path)
        t = time.perf_counter()
        try:
            with chaos_scope(spec):
                _, report = run_federated_training(
                    fc, build_for_width, state, P26_FED_STEPS, manager=mgr,
                    mesh_for_width=lambda w: (make_mesh(dp=1), None), stores=stores, snapshot_every=1,
                    recover_after=3, on_step=lambda step, loss, width: widths.append(width))
        finally:
            monitor.set_event_log(None)
            install_ledger(None)
        torch.cuda.synchronize()
        return report, ledger, [json.loads(line) for line in open(log_path)], log_path, time.perf_counter() - t

    full, _, _, _, full_s = run("full", "")
    widths.clear()
    lost, ledger, recs, log_path, lost_s = run("lost", "slice_loss@2,slice=1")
    decisions = [r["actuator"] for r in recs if r["kind"] == "autopilot_decision"]
    tiers = [(r["step"], r["tier"]) for r in recs if r["kind"] == "restore" and r.get("ok")]
    ts = {r["kind"] + (r.get("actuator") or ""): r["ts"] for r in recs
          if r["kind"] in ("autopilot_decision", "elastic_resume") and (r.get("actuator") == "shrink_dp"
                                                                        or r.get("tier") == "peer")}
    peer_s = ts.get("elastic_resume", 0.0) - ts.get("autopilot_decisionshrink_dp", 0.0)
    summary, diags = ev_replay.replay_events(log_path, storm_threshold=64)
    rel = [abs(a.item() - b.item()) / abs(b.item()) for a, b in zip(lost.losses, full.losses)]
    log(f"  (c) 2 slices of one rank, {small.n_layer} layers, {P26_FED_STEPS} steps: full width {full_s:.1f} s, "
        f"losses {', '.join(f'{x.item():.6f}' for x in full.losses)}; slice_loss@2,slice=1 with recover_after=3 "
        f"{lost_s:.1f} s: widths {widths}, decisions {decisions}, restores {tiers}, ledger "
        f"{[(f, t) for _, f, t, _ in ledger.transitions]}, report shrinks {lost.shrinks} regrows {lost.regrows} "
        f"degraded_steps {lost.degraded_steps}; losses {', '.join(f'{x.item():.6f}' for x in lost.losses)}, "
        f"largest relative gap {max(rel):.2e} (limit {FED_LOSS_RTOL}); the peer-tier restore {peer_s:.3f} s; "
        f"replay unrecovered {summary['unrecovered_faults']}, unactuated {summary['unactuated_decisions']}")
    require(decisions == ["shrink_dp", "regrow_dp"] and lost.shrinks == 1 and lost.regrows == 1,
            "the slice loss did not shrink and regrow once each")
    require([t for _, t in tiers].count("peer") == 1 and "disk" not in [t for _, t in tiers[1:]],
            "the shrink's restore did not come from the buddy's RAM alone")
    require(1 in widths and all(x <= FED_LOSS_RTOL for x in rel) and rel[0] == rel[1] == 0.0,
            "the width-1 losses are not those of the full-width run")
    require(not summary["unrecovered_faults"] and not summary["unactuated_decisions"]
            and not any(d.severity.name == "ERROR" for d in diags), "the federation's log does not replay clean")


def run_fleet(cfg, launches: dict) -> None:
    """Phase 26 (a)-(c), one NCCL rank, the ops plane armed by
    ``monitor.serve(port=0)`` for (a) and (b)."""
    import os
    import shutil
    import tempfile

    import thunder_tpu_torch.distributed as td
    from thunder_tpu_torch import monitor

    root = tempfile.mkdtemp(prefix="phase26-")
    dist_init()
    plane = monitor.serve(port=0, flightrec_dir=os.path.join(root, "flightrec"))
    try:
        log(f"  (b) the ops plane on 127.0.0.1:{plane.port}")
        t = time.perf_counter()
        got = run_autopilot(cfg, root, plane, launches)
        log(f"  (a) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_plane_overhead(plane, cfg, got["vg"], got["params"], got["batch"])
        log(f"  (b) took {time.perf_counter() - t:.1f} s")
        del got
        gc.collect()
        torch.cuda.empty_cache()
        monitor.shutdown_ops()
        t = time.perf_counter()
        run_federation(cfg, root)
        log(f"  (c) took {time.perf_counter() - t:.1f} s")
    finally:
        monitor.shutdown_ops()
        gc.collect()
        torch.cuda.synchronize()
        td.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    require(not td.is_initialized(), "the process group outlived phase 26")


# Phase 27: the layers of (a)'s staged step and of (b)'s ddp step (width kept).
AUDIT_LAYERS = 4
DDP_AUDIT_LAYERS = 2
# (a): the kernel rows of the path, by the csrc/ function whose graph nodes
# count one launch of each wrapper.
AUDIT_ROWS = {"flash_fwd_lse": "flash_fwd_kernel", "flash_bwd": "flash_bwd_dkdv_kernel", "rope": "rope_kernel",
              "ce_fwd": "ce_fwd_kernel", "ce_bwd": "ce_bwd_kernel"}
AUDIT_FLOPS_REL = 0.01


def run_audited_step(cfg, launches: dict) -> None:
    """Phase 27 (a). The staged ``value_and_grad`` of open_llama_3b at
    AUDIT_LAYERS layers: the compile phase's report of the captured graph,
    its kernel nodes against the capture's launch counts, its priced
    operations against ``trace_cost``."""
    import os
    import tempfile

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis.cost import trace_cost
    from thunder_tpu_torch.models import gpt

    cfg = replace(cfg, n_layer=AUDIT_LAYERS)
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    gen = np.random.RandomState(SEED + 270)
    idx = torch.from_numpy(gen.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(gen.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") as d:
        log_path = os.path.join(d, "events.jsonl")
        vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), events=log_path)
        _zero_counts()
        t0 = time.perf_counter()
        for _ in range(2):  # warm-up, capture (and the audit)
            loss, _ = vg(params, idx, tgt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        phase = [json.loads(line) for line in open(log_path) if '"hlo_audit"' in line]
    entry = tt.compile_stats(vg).cache_entries[-1]
    rep, stage = entry.hlo_audit, entry.computation_fn
    require(rep is not None and rep.source == "graph" and tt.last_staging(vg).staged,
            "(a): the staged step carries no report of its graph")
    # The same step compiled and captured again, the audit off and on in
    # turns: what the audit adds to a capture (the graph kept,
    # the line marks, the dump), and its phase after it.
    turns = {"0": [], "1": []}
    for knob in ("0", "1", "0", "1"):
        os.environ["THUNDER_TPU_HLO_AUDIT"] = knob
        try:
            again = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
            for _ in range(2):
                again(params, idx, tgt)
            torch.cuda.synchronize()
            phases = tt.compile_stats(again).cache_entries[-1].stats.phases
            turns[knob].append((tt.last_staging(again).capture_s, phases.get("hlo_audit", 0.0)))
        finally:
            del os.environ["THUNDER_TPU_HLO_AUDIT"]
        del again
    launched = {name: n for (_, name), n in stage._delta.items()}
    wrappers = {"flash_fwd_lse": "flash_attention_fwd_lse", "flash_bwd": "flash_attention_bwd", "rope": "apply_rope",
                "ce_fwd": "cross_entropy_rows", "ce_bwd": "cross_entropy_bwd"}
    rows = {row: (rep.port_kernels.get(fn, 0), launched.get(wrappers[row], 0)) for row, fn in AUDIT_ROWS.items()}
    want = trace_cost(entry.computation_traces[-1]).total_flops
    rel = abs(rep.flops - want) / want
    (span,) = phase
    log(f"  (a) {cfg.n_layer} layers, B={LOSS_BATCH}, T={SEQ}: loss {loss.item():.6f}; warm-up and capture "
        f"{wall:.2f} s; graph {rep.n_ops} nodes ({sum(rep.kernels.values())} kernels, {len(rep.kernels)} by name), "
        f"{rep.streams} branch(es); dump {span.get('hlo_dump_bytes')} bytes, parsed in {span['hlo_acquire_s']:.3f} s, "
        f"audited in {span['hlo_analyze_s']:.3f} s (phase {span['s']:.3f} s)")
    log(f"  (a) capture (and first replay), then the audit phase, s, in turns: audit off "
        f"{', '.join(f'{c:.3f}' for c, _ in turns['0'])}; on {', '.join(f'{c:.3f} + {a:.3f}' for c, a in turns['1'])} "
        f"(the first entry's: {tt.last_staging(vg).capture_s:.3f} + {span['s']:.3f})")
    log(f"  (a) kernel rows (graph nodes, launches the capture counted): {rows}; port kernels {rep.port_kernels}")
    log(f"  (a) priced {rep.flops / 1e12:.4f} TFLOP over {rep.lines_priced} lines against trace_cost's "
        f"{want / 1e12:.4f} (rel {rel:.2e}); {rep.matmuls} matmul nodes; {rep.unpriced} unpriced; layout copies "
        f"{rep.layout_copies} ({rep.layout_copy_bytes / 1e6:.2f} MB); host transfers {rep.host_transfers}; "
        f"sites {len(rep.sites)}, exposed {rep.exposed_pct:.1f}%")
    for line in rep.format().splitlines()[:3]:
        log(f"  (a) | {line}")
    by_line: dict = {}
    for op in rep.layout_copy_ops:
        sym = op.split("@")[-1].split("#")[0].split(".", 1)[-1] if "@" in op else "(no line)"
        by_line[sym] = by_line.get(sym, 0) + 1
    log(f"  (a) layout copies by the symbol of their line: {dict(sorted(by_line.items(), key=lambda kv: -kv[1]))}")
    require(all(n == c and n > 0 for n, c in rows.values()), f"(a): graph nodes against launches {rows}")
    require(rel <= AUDIT_FLOPS_REL, f"(a): priced operations {rep.flops} against trace_cost's {want}")
    require(rep.host_transfers == 0, f"(a): host transfers in the step: {rep.host_transfer_ops[:4]}")
    require(stage.graph_dump is None, "(a): the stage kept its dump after the audit")
    for row in AUDIT_ROWS:
        require(counts[row] > 0, f"(a): the path launched no {row}")
        launches[row] = launches.get(row, 0) + counts[row]
    del vg, params, loss, entry, stage
    gc.collect()
    torch.cuda.empty_cache()


def run_audited_ddp() -> None:
    """Phase 27 (b). Phase 22's ddp step (the Llama stand-in at full width,
    DDP_AUDIT_LAYERS layers) at one NCCL rank, staged forward and backward,
    audited from its two graphs (``audit_jitted``)."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis.hlo_audit import audit_jitted
    from thunder_tpu_torch.observability.attribution import COLLECTIVE_SYM_CLASS

    cfg = replace(OPEN_LLAMA_3B, num_hidden_layers=DDP_AUDIT_LAYERS)
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    m = _dist_llama("ddp", cfg)
    tm = tt.jit(m)
    opt = torch.optim.SGD(m.parameters(), lr=LLAMA_LR)
    for _ in range(2):  # warm-up, capture
        tm(ids, am, labels)["loss"].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = audit_jitted(tm)
    audit_s = time.perf_counter() - t0
    traces = (tt.last_traces(tm)[-1], tt.last_backward_traces(tm)[-1])
    lines = [b.sym.name for trc in traces for b in trc.bound_symbols if b.sym.name in COLLECTIVE_SYM_CLASS]
    with_nodes = [s for s in rep.sites if s.nodes]
    log(f"  (b) ddp, {cfg.num_hidden_layers} layers: graphs {rep.n_computations} ({rep.n_ops} nodes), audited in "
        f"{audit_s:.3f} s; sites {len(rep.sites)} by family {{{', '.join(f'{f}: {a['count']}' for f, a in rep.by_family.items())}}}, "
        f"{rep.explicit_collectives} explicit, {rep.inserted_collectives} inserted; collective lines in the traces "
        f"{len(lines)}; sites with nodes at one rank {len(with_nodes)} ({sum(s.nodes for s in with_nodes)} nodes: "
        f"{sorted({s.opcode for s in with_nodes})[:3]})")
    measured = _NOTES.get("timeline_exposed_pct")
    log(f"  (b) predicted exposed share {rep.exposed_pct:.1f}% of {rep.wire_us:.3f} us of wire (one rank: no byte "
        f"on the wire); the timeline's measured exposed share of the 26-layer ddp step's working time, phase 23 (c): "
        f"{'not measured' if measured is None else f'{measured:.3f}%'}")
    require(rep.inserted_collectives == 0 and rep.explicit_collectives == len(lines) == len(rep.sites) > 0,
            f"(b): {len(rep.sites)} sites ({rep.inserted_collectives} inserted) for {len(lines)} collective lines")
    del tm, m, opt, rep
    gc.collect()
    torch.cuda.empty_cache()


def run_audit_faults(cfg) -> None:
    """Phase 27 (c). Planted host transfers, and the kill switch."""
    import os

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis import hlo_audit
    from thunder_tpu_torch.examine import hlo_report
    from thunder_tpu_torch.executors import fusedex, staging

    x = torch.randn(256, 256, device="cuda")

    def with_item(a):
        s = a.sum().item()  # the planted host read: the program cannot stage
        return a * 2, s

    jg = tt.jit(with_item)
    rep = hlo_report(jg, x, verbose=False)
    fired = [d.rule for d in rep.diagnostics()]
    log(f"  (c) .item() in a program: staged {tt.last_staging(jg).staged} ({tt.last_staging(jg).reason}); its record's "
        f"audit: host transfers {rep.host_transfer_ops[:3]}; findings {fired}")
    require("hlo.host-transfer-in-step" in fired, "(c): the .item() did not fire hlo.host-transfer-in-step")

    pinned = torch.empty(256, 256, pin_memory=True)
    host_src = torch.randn(64, pin_memory=True)
    side = torch.cuda.Stream()
    B, T, H, D = 1, 16, 2, 64
    q = torch.randn(B, H, T, D, device="cuda", dtype=torch.bfloat16)
    cos, sin = (torch.randn(T, D, device="cuda", dtype=torch.bfloat16) for _ in range(2))

    def probe(a):
        y = a * 2 + 1
        z = torch.mm(y, y)
        c = torch.empty_like(z)
        c.copy_(z)  # a memcpy from the device to the device
        t = z.t().contiguous()  # a copy kernel
        pinned.copy_(z, non_blocking=True)  # the planted transfer to the host
        h = host_src.to("cuda", non_blocking=True)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            s2 = y.sin()
        torch.cuda.current_stream().wait_stream(side)
        r = fusedex.apply_rope(q, cos, sin)  # a port kernel
        return c, t, h, s2, r

    stage = staging.CudaGraphStage(probe, name="audit probe")
    for _ in range(2):
        stage(x)
    dump = stage.graph_dump
    rep = hlo_audit.audit_jitted(stage)
    fired = [d.rule for d in rep.diagnostics()]
    log(f"  (c) staged probe with a copy into pinned host memory: {rep.n_ops} nodes, host transfers "
        f"{rep.host_transfer_ops}, layout copies {rep.layout_copies}, port kernels {rep.port_kernels}; findings {fired}")
    log(f"  (c) the probe's graph, {len(dump)} bytes of DOT text (the CPU tests' golden excerpt):")
    for line in dump.splitlines():
        print(f"  (c) | {line}")
    require("hlo.host-transfer-in-step" in fired and rep.host_transfers == 2 and rep.port_kernels.get("rope_kernel") == 1,
            "(c): the staged probe's transfers or its port kernel were not found")

    os.environ["THUNDER_TPU_HLO_AUDIT"] = "0"
    try:
        jf = tt.jit(lambda a: (a @ a).tanh().sum())
        for _ in range(3):
            jf(x)
        entry = tt.compile_stats(jf).cache_entries[-1]
        killed = (entry.hlo_audit, entry.computation_fn.graph_dump, entry.computation_fn.line_marks,
                  "hlo_audit" in entry.stats.phases)
    finally:
        del os.environ["THUNDER_TPU_HLO_AUDIT"]
    log(f"  (c) THUNDER_TPU_HLO_AUDIT=0: staged {tt.last_staging(jf).staged}; report, dump, marks, phase {killed}")
    require(tt.last_staging(jf).staged and killed == (None, None, [], False), "(c): the kill switch left an audit")


def run_hlo_audit(cfg, launches: dict) -> None:
    """Phase 27 (a)-(c); (b) in its own one-rank NCCL group."""
    import thunder_tpu_torch.distributed as td

    t = time.perf_counter()
    run_audited_step(cfg, launches)
    log(f"  (a) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dist_init()
    try:
        run_audited_ddp()
    finally:
        gc.collect()
        torch.cuda.synchronize()
        td.shutdown()
    require(not td.is_initialized(), "the process group outlived phase 27 (b)")
    log(f"  (b) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    run_audit_faults(cfg)
    log(f"  (c) took {time.perf_counter() - t:.1f} s")


# =============================================================================
# Phase 28: the runnable tools (examples/, scripts/) on the card
# =============================================================================

EXAMPLE_MODEL = "pythia-160m"  # examples/train.py's default
EXAMPLE_ITERS = 3
EXAMPLE_WARMUP = 2
P28_PROFILE_LAYERS = 4  # open_llama_3b's depth for profile_train
# The port kernels each claimed line of the profiled step must hold.
P28_LINE_KERNELS = {"sdpa_fwd_res": ("flash_fwd_kernel",), "sdpa_bwd_res": ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"),
                    "cross_entropy": ("ce_fwd_kernel",), "cross_entropy_bwd": ("ce_bwd_kernel",),
                    "apply_rope": ("rope_kernel",)}


def run_example_train(launches: dict) -> None:
    """Phase 28 (a): ``thunder_tpu_torch.examples.train.run`` with the
    example's defaults (pythia-160m, full depth and width, T = its
    block_size, SGD, seed 42) at B=2: the launches of the run equal the
    claimed trace's a step times the steps, flash forward-with-lse and
    backward and CE forward and backward among them, rope only where the
    trace claims it; finite losses; s/iter and tok/s printed."""
    import torch

    from thunder_tpu_torch.examples import train

    gc.collect()
    torch.cuda.empty_cache()
    args = train.parse_args(["--model", EXAMPLE_MODEL, "--iters", str(EXAMPLE_ITERS), "--warmup",
                             str(EXAMPLE_WARMUP), "--micro-batch-size", str(LOSS_BATCH)])
    out: dict = {}
    _zero_counts()
    losses = train.run(args, out=out)
    counts = _launch_counts()
    src = out["extrace"].python()
    claimed = {k: src.count(v) for k, v in CLAIMED.items()}
    steps = 1 + EXAMPLE_WARMUP + EXAMPLE_ITERS
    stats = out["step"].staging
    log(f"  {EXAMPLE_MODEL}: {out['seconds'] / EXAMPLE_ITERS:.4f} s/iter, "
        f"{out['tokens'] / out['seconds']:.1f} tok/s over {EXAMPLE_ITERS} iters after {EXAMPLE_WARMUP} warm-up "
        f"steps (B={LOSS_BATCH}, T={args.seq_len or 2048}); losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"staged {stats.staged}, replays {stats.replays}; claimed per step {claimed}; launches over {steps} steps "
        f"{ {k: v for k, v in counts.items() if v} }")
    require(len(losses) == EXAMPLE_ITERS and all(math.isfinite(x) for x in losses),
            f"examples.train: losses {losses}")
    require(stats.staged, f"examples.train: the step did not stage ({stats.reason})")
    for k in ("flash_fwd_lse", "flash_bwd", "ce_fwd", "ce_bwd"):
        require(claimed[k] > 0, f"examples.train: the step claims no {k}")
    for k, n in claimed.items():
        require(counts[k] == n * steps, f"examples.train: {k} launched {counts[k]} times in {steps} steps, the trace "
                                        f"claims {n} a step")
    log(f"  rope: {'claimed' if claimed['rope'] else 'not claimed'} on {EXAMPLE_MODEL}'s step (its rotary covers "
        f"a quarter of the head; the kernel claims a full-width rotate-half)")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def run_lint_corpus() -> None:
    """Phase 28 (b): the trace verifier's default corpus on the card."""
    from thunder_tpu_torch.scripts import lint_traces

    rc = lint_traces.main(["--device", "cuda"])
    require(rc == 0, f"lint_traces --device cuda exited {rc}")


def run_profile_report(launches: dict) -> None:
    """Phase 28 (c): ``profile_train`` on open_llama_3b at full width and
    P28_PROFILE_LAYERS layers (B=2 x T=2048, the staged step, 3 profiled
    steps), then ``perf_report``'s attribution of its directory with the
    cost join: every step's graph kernels equal to the launch-order map and
    every one placed on a line (the backward's seed is made once, so no
    fill kernel runs outside the lines), the flash, CE and rope kernels
    under the lines that claim them, at least ATTRIBUTED_SHARE of device
    time attributed (the rest: the staged step's copy of its loss out of
    the graph's pool, launched outside the graph and any line), a line
    priced by the join; the attributed share printed."""
    import tempfile

    import torch

    from thunder_tpu_torch.analysis.hlo_audit import port_kernel_of
    from thunder_tpu_torch.scripts import perf_report, profile_train

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="prof_train_") as d:
        args = profile_train.parse_args([d, "--layers", str(P28_PROFILE_LAYERS)])
        _zero_counts()
        res = profile_train.run(args)
        counts = _launch_counts()
        t0 = time.perf_counter()
        join = perf_report.attribution_of(d, model=CFG_NAME)
        report_s = time.perf_counter() - t0
        del res["train"]
    attr = join.attribution
    found: dict = {}
    for (ref, name), (us, n) in attr.ops.items():
        k = port_kernel_of(name)
        if ref is not None and k is not None:
            found.setdefault(ref.sym, set()).add(k)
    log(f"  profile_train: {P28_PROFILE_LAYERS} layers, avg step {res['avg_s']:.4f} s over {profile_train.STEPS} "
        f"steps; "
        f"perf_report ({report_s:.1f} s with the cost join): {attr.coverage * 100:.2f}% of "
        f"{join.measured_step_us / 1e3:.3f} device ms a step attributed to {len(attr.by_line)} lines; graph kernels "
        f"{attr.graph_placed} of {attr.graph_ops} placed, {attr.graph_mismatched} step(s) differing; port kernels "
        f"by line symbol { {s: sorted(k) for s, k in sorted(found.items())} }")
    print(join.format(8), flush=True)
    require(attr.mode == "cuda" and attr.graph_ops > 0 and not attr.graph_mismatched,
            f"perf_report: {attr.graph_ops} graph kernels, {attr.graph_mismatched} step(s) differing from the map")
    require(attr.graph_placed == attr.graph_ops,
            f"perf_report: {attr.graph_ops - attr.graph_placed} of {attr.graph_ops} graph kernels on no line")
    for sym, kernels in P28_LINE_KERNELS.items():
        require(set(kernels) <= found.get(sym, set()), f"perf_report: {sym}'s lines hold {found.get(sym)}, "
                                                        f"expected {kernels}")
    require(attr.coverage >= ATTRIBUTED_SHARE, f"perf_report: only {attr.coverage:.2%} of device time attributed")
    require(any(r.roofline_us for r in join.rows), "perf_report: the cost join priced no line")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def run_tools(launches: dict) -> None:
    """Phase 28 (a)-(c)."""
    t = time.perf_counter()
    run_example_train(launches)
    log(f"  (a) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    run_lint_corpus()
    log(f"  (b) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    run_profile_report(launches)
    log(f"  (c) took {time.perf_counter() - t:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from thunder_tpu_torch.executors import _build
    from thunder_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.name_to_config(CFG_NAME)

    log("[1] card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # name, power limit: every time below was taken at this limit
    log(f"  torch: {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}")

    log("[2] build")
    info = _build.build()
    _build.lib()
    log(f"  built {info.path.name} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or line.startswith("nvcc "):
            log(f"  {line.strip()}")

    pythia = gpt.name_to_config(PYTHIA)
    log(f"[3] kernels at {CFG_NAME}'s and {PYTHIA}'s path shapes, and the masked kernels at the padded path's")
    rows: dict[str, dict] = {}
    check_kernels(cfg, rows)
    check_norm_kernels(cfg, pythia, rows)
    check_pythia_shapes(pythia, rows)
    check_masked_kernels(cfg, rows)
    check_legacy_kernels(cfg, rows)
    check_int8_kernel(rows)
    check_quant_kernels(rows)

    log(f"[4] {CFG_NAME} at full width, 2 layers: default executors vs torch executor, forward and gradients")
    check_two_layers(cfg)

    log(f"[5] {CFG_NAME}, {cfg.n_layer} layers")
    launches = run_full(cfg)

    log(f"[6] {CFG_NAME}, {cfg.n_layer} layers: training step, unstaged and staged")
    splash_losses, bf16_staged = run_train(cfg, launches)

    log(f"[7] {PYTHIA} at full width, 2 layers: {NORM_STACK} vs torch executor, forward and gradients")
    check_pythia_two_layers(pythia)

    n = pythia.n_layer
    log(f"[8] {PYTHIA}, {n} layers: litgpt training benchmark, AdamW, default executors and {NORM_STACK}")
    attn = {"flash_fwd_lse": n, "flash_bwd": n, "ce_fwd": 1, "ce_bwd": 1}
    run_litgpt(PYTHIA, "flash,fused,torch", attn, launches, optimizer="adamw", warmup=2, iters=5)
    _, run = run_litgpt(PYTHIA, NORM_STACK, {**attn, "ln_fwd": 2 * n + 1, "ln_bwd": 2 * n + 1}, launches,
                        optimizer="adamw", warmup=2, iters=5)
    check_adamw_step(run)
    del run
    compare_litgpt_staging(PYTHIA, "flash,fused,torch")

    n = cfg.n_layer
    log(f"[9] {CFG_NAME}, {n} layers: litgpt training benchmark, SGD, {NORM_STACK}")
    run_litgpt(CFG_NAME, NORM_STACK, {"flash_fwd_lse": n, "flash_bwd": n, "ce_fwd": 1, "ce_bwd": 1, "rope": 4 * n,
                                      "rms_fwd": 2 * n + 1, "rms_bwd": 2 * n + 1},
               launches, optimizer="sgd", warmup=2, iters=3)

    log(f"[10] the Llama stand-in at {CFG_NAME}'s full width, 2 layers, padded batch: jit(module) vs torch "
        "executor, forward and gradients; the exact branch")
    check_llama_two_layers()

    log(f"[11] the Llama stand-in, {OPEN_LLAMA_3B.num_hidden_layers} layers, padded batch: forward without grad, "
        "all-ones mask, 3 SGD steps")
    run_llama(launches)

    log(f"[12] {CFG_NAME}, {cfg.n_layer} layers: 3 staged training steps under THUNDER_FLASH_IMPL=legacy")
    run_legacy_train(cfg, splash_losses, launches)

    log(f"[13] {CFG_NAME}: mixed precision (f32 weights, autocast=bfloat16), 2 layers vs the torch executor, then "
        f"{cfg.n_layer} layers, 3 steps unstaged and staged")
    check_autocast_two_layers(cfg)
    run_autocast_train(cfg, launches, bf16_staged)

    log("[14] keyed random draws: the draw kernel at the path's shapes, a staged dropout")
    check_draw_kernel(rows)
    run_dropout(launches)

    log(f"[15] {CFG_NAME}, {cfg.n_layer} layers: the int8 training step ({','.join(QUANT_STACK)}), SGD, "
        "unstaged and staged")
    run_quant_train(cfg, launches, splash_losses)

    log(f"[16] symbolic values on the serving path: {CFG_NAME}'s forward over T = "
        f"{', '.join(map(str, SYM_LENGTHS))} in 128-wide buckets; the Llama stand-in under seq_bucket=128")
    run_symbolic_serving(cfg, launches)

    log(f"[18] per-sample gradients: vmap(grad(loss_fn)) over {PS_SAMPLES} samples of (1, {SEQ}), grad of vmap, "
        f"jvp; 2 layers, then {cfg.n_layer} layers staged")
    run_per_sample(cfg, launches)

    log(f"[19] the last batching rules at full width: (a) masked per-sample grads over a padded batch, 2 then "
        f"{cfg.n_layer} layers; (b) an ensemble of two models under {NORM_STACK}; (c) per-sample grads under the "
        "quant stack")
    masked = run_masked_per_sample(cfg, launches)
    run_ensemble(cfg, launches)
    run_quant_per_sample(cfg, launches)

    log("[20] the analysis layer: (a) the verifier at every pass of the staged step and the forward; (b) predicted "
        "peaks against max_memory_allocated, mem.predicted-oom; (c) cost.py against the kernel rows' bounds")
    run_verifier(cfg)
    run_liveness(cfg, masked)
    del masked
    run_cost(cfg, rows)

    log("[21] the observability layer: (a) metrics and the event log of the staged loss and step, replayed, a hit "
        "with metrics off and on; (b) the NaN watch, OpTimer and MemoryHighWater on 2 layers; (c) the staged "
        "training step profiled and attributed to trace lines; (d) the roofline sampler; (e) targets")
    run_events(cfg)
    run_instrument(cfg, rows)
    tr = run_attribution(cfg, rows, launches)
    run_roofline(tr, launches)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    run_targets()

    log("[22] distribution on torch.distributed, one NCCL rank: (a) each collective prim staged at the path's shapes; "
        f"(b) the Llama stand-in, {OPEN_LLAMA_3B.num_hidden_layers} layers, 3 staged SGD steps under ddp, fsdp ZERO2 "
        "and ZERO3 against the untagged steps, (e) the ddp step attributed; (c) no_sync, 2 layers; (d) the ZERO3 "
        "state through distributed.checkpoint")
    import thunder_tpu_torch.distributed as td

    dist_init()
    try:
        run_dist_prims()
        run_dist_llama(launches)
        run_dist_no_sync()
        run_dist_checkpoint()
    finally:
        gc.collect()
        torch.cuda.synchronize()
        td.shutdown()
    require(not td.is_initialized(), "the process group outlived phase 22")

    log(f"[23] the mesh and the sharded training step, one NCCL rank: (a) {CFG_NAME}, {cfg.n_layer} layers, on "
        "make_mesh(dp=1, fsdp=1, tp=1) against the unmeshed step, SGD and AdamW; (b) the LitGPT CLI through "
        "benchmarks/distributed.run_config; (c) ran above, on phase 22 (b)'s ddp step")
    dist_init()
    try:
        run_mesh_step(launches)
        run_mesh_cli()
    finally:
        gc.collect()
        torch.cuda.synchronize()
        td.shutdown()
    require(not td.is_initialized(), "the process group outlived phase 23")

    log(f"[24] context, pipeline and expert parallelism, one NCCL rank: (a) {CFG_NAME}, {PP_LAYERS} layers, "
        f"pipelined on pp=1, GPipe and 1F1B against the unpipelined step; (b) mixtral-8x7b's expert MLP at ep=1; "
        "(c) ring and Ulysses attention at sp=1; (d) a mesh naming pp, ep and sp at 1")
    dist_init()
    try:
        from thunder_tpu_torch.parallel import make_mesh

        run_pipelined(launches)
        run_moe(make_mesh(ep=1))
        run_context(make_mesh(sp=1))
        run_axes_at_one(cfg, launches)
    finally:
        gc.collect()
        torch.cuda.synchronize()
        td.shutdown()
    require(not td.is_initialized(), "the process group outlived phase 24")

    log(f"[25] the recovery layer: (a) {CFG_NAME}, {cfg.n_layer} layers, run_training preempted at step 2 and "
        "resumed by a fresh manager and jit; (b) snapshots and a host loss, the RAM-tier elastic resume; (c) the "
        "de-opt ladder on a real out-of-memory; (d) kernel_raise on the flash wrapper; (e) the NaN guard; (f) the "
        "collective watchdog at jit's and shard_map_callable's dispatch, one NCCL rank")
    run_resilience(cfg, launches)

    log(f"[26] the fleet layer, one NCCL rank, the ops plane armed: (a) {CFG_NAME} at {P26_LAYERS} layers, the "
        "autopiloted run under a collective hang, a preemption and an out-of-memory; (b) the four endpoints, the "
        "flight recorder's dumps and the plane's cost on a staged hit; (c) the federated run over 2 slices under a "
        f"slice loss, {P26_FED_LAYERS} layers")
    run_fleet(cfg, launches)

    log(f"[27] the compiled-program audit: (a) {CFG_NAME} at {AUDIT_LAYERS} layers, the staged value_and_grad's graph "
        f"against the capture's launches and trace_cost; (b) phase 22's ddp step at {DDP_AUDIT_LAYERS} layers, one "
        "NCCL rank; (c) planted host transfers, the kill switch")
    run_hlo_audit(cfg, launches)

    log(f"[28] the runnable tools: (a) examples.train on {EXAMPLE_MODEL}, full depth, B={LOSS_BATCH}, staged; (b) the "
        f"trace verifier's corpus on the card; (c) profile_train on {CFG_NAME} at {P28_PROFILE_LAYERS} layers, then "
        "perf_report --trace-dir with the cost join")
    run_tools(launches)

    rows = list(rows.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "row_rel_err", "row_rel_limit",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: (launches[r["name"]] if k == "launches" else r[k]) for k in keys} for r in rows]
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
