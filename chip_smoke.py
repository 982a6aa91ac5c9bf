#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any mismatch exits non-zero; nothing is caught and passed over):

  0. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc``; check that fp32 matmuls stay fp32.
  1. each kernel against its plain PyTorch version on the card, at the
     Model-1 (dense kernels) and Model 1-struct (patchy kernels) shapes of
     the main path (the update kernels also on a padded tail batch, and
     the resident-trace ones at a = 1, a fit's first step, where pij' is
     the product itself; patchy_update's silent entries held bit for bit)
     and one ragged shape, and at batch 64 at Table-1 Models 2 and 3's
     (``m2-*``/``m3-*`` rows: 1568 -> 32x256, 8192 -> 1x2 and 8192 ->
     32x128 for the dense kernels, with 36- and 34-row tails for the
     update; nact 128 of 784 and of 4096 pre-HCs for the gathered ones),
     each with its time
     (CUDA-graph replay of 20 launches, median of 10), the plain version's
     time, one PyTorch library call's time where one computes the same
     function, and the least time the card could take (``bound_ms``).
     The forward kernels also read bf16 weights (a bf16 serving pack);
     ``torch.addmm`` (fp32, TF32 off) is timed beside each ``bcpnn_fwd``
     row, and ``torch.bmm`` on pre-gathered (Hj, B, K) and (Hj, K, Mj)
     operands beside each ``patchy_forward``/``compact_forward`` row, as
     the library's time for the product alone, with the cluster size the
     forward takes there; each forward row must also repeat bit for bit
     over 10 launches, and rows at Model 1's hidden shape and behind a
     Model 1-struct table hold the forwards with fitted-range log-odds
     weights to fp64; the three int8
     kernels (one s8 tensor-core body) run at Model 1's hidden shape,
     Model 1-struct's and a ragged one, with ``torch._int_mm`` timed beside
     ``quant_fwd`` as a yardstick for the int8 product alone;
     ``quant_fwd`` also at Ni = 8192 with every code at +-127 (sums past
     2**24); each int8 row with the plan it takes (tile rows, cluster
     size) and required to repeat bit for bit, and the dense forward at
     Model 1 and the two gathered ones at Model 1-struct timed under each
     forced plan (tiles of 64 or 128 rows, clusters of 1 to 4), with the
     same rates bit for bit under every plan, and whether ``torch.bmm``
     takes their int8 operands (the product alone); each
     ``hc_softmax`` row (also M = 2, a segment a lane) with its sub-warp
     width and load width.  The peaks that price ``bound_ms`` are
     ``repro_torch.launch.roofline``'s; each dense and int8 forward row's
     bytes are held to that module's ``bcpnn_fwd_traffic`` (equal, or both
     printed with the reason they differ).  Then ``bcpnn_fwd`` at Model
     3's hidden shape (B 64, 8192 -> 32x128) timed under every cluster
     size the shape allows, each named through an autotune cache file
     under ``chiprun_out/`` (``kernels/tuning.py``), the launched size
     read back, the rates within 1e-5 of the plain version: a reading of
     the launch plans, not a claim.
  2. the paper's protocol at the full width of Table-1 Model 1 (784x2 ->
     32x128 -> 10): ``Trainer.fit`` for 5 unsupervised epochs and one
     supervised pass over 16384 synthetic images, then ``evaluate`` on
     train and test, with every kernel's launch count over that run (as
     predicted); the fit's epoch programs replay captured steps, and the
     eager loop of the same step functions from the same seed must end in
     the same state bit for bit, with ``unsup_s``/``sup_s`` of both and
     ``evaluate`` (``eval_batches``) equal to the eager accuracy; then
     a fit whose data does not divide the batch (1000 images: 7 whole
     batches and a 104-row tail), which must launch the update kernel on
     every step, the masked tail's too, and whose masked steps must match
     the plain backend's from the same state.
  3. serving on the fitted state: a padded request bucket with its
     validity mask, the kernel path against the plain-torch path on 2048
     test rows (hidden rates, both held against fp64, and served
     probabilities), and feedback
     folded with ``online_learn_step`` on both backends.
  5. structural plasticity at the full width of Table-1 Model 1-struct
     (784x2 -> 32x128 -> 10, nact 128, a rewire every 64 steps) in its
     three plasticity layouts: (c) compact-resident, (b) patchy-held,
     (a) the paper's default (patchy forward, dense masked update).  Each
     fits as phase 2 does (graphed against the eager loop, bit for bit,
     masks and tables equal), with its launch counts checked against the
     prediction, its masks exactly-nact and valid after 10 rewires, and
     (c) held to the JAX reference's test accuracy.  Then 70 unsupervised
     steps across a rewire, a readout step and an online fold with the
     card forbidden to synchronise, eagerly and as replays of the captured
     steps (and an eval batch); a (c) fit with a padded tail; single
     steps from one state, kernels against the plain backend (a masked
     unsupervised step, and an online fold from trace clock 63 that
     crosses a rewire); and (c)'s hidden rates against fp64.
  6. low-precision serving of the fitted Model 1 and Model 1-struct
     (a), (b), (c) states: test accuracy in int8 and bf16 against fp32
     (the repo's 0.5-point gate), with the launch counts of those
     evaluations as predicted; for int8, a padded request bucket, the
     kernel path against the plain path on 2048 test rows, a repack after
     a feedback fold that must serve the new scales, and packing and
     serving with the card forbidden to synchronise.
  8. checkpoints and serving at full width: phase 2's Model-1 trainer
     saved (``Trainer.save``, timed) and loaded from the directory alone
     (``load_model``, timed), every tensor and the generator's state equal
     and the same ``evaluate``; Model-1 and (c) fits checkpointing every 64
     batches, killed by ``on_chunk`` raising ``WorkerLost`` mid
     unsupervised epoch, resumed by a trainer of another seed and held to
     the uninterrupted fit bit for bit, generator included ((c) rewires
     after the kill); ``BCPNNService`` streams (default buckets 1..64, one
     captured CUDA graph each) of all 2048 test rows at a Poisson 4000/s
     over Model 1 in fp32 and int8 and (c) in int8, every served batch held
     to eager ``infer_packed`` on the same padded group bit for bit, served
     accuracy equal to the evaluation's, the launch counts reset before
     each stream and read after (each the sum of its replays' captures),
     with p50/p99 latency, images/s and the launches of each bucket's
     graph; a cold Model-1 readout relearned from a feedback stream while
     serving (above the launcher's floor) and (b) learning its stack with a
     rewire while serving, each equal to an offline replay of the same
     feedback bit for bit, and (b)'s batches served after the rewire equal
     to eager ``infer_packed``; the quarantine (a ``nan-state`` fault and a
     NaN feedback row through the kernels) rolling back bit for bit while
     the slot keeps serving; and ``python -m
     repro_torch.launch.serve_bcpnn --smoke`` in a process of its own (its
     phase 5 the router failover).
  9. the multi-engine router at full width (``[phase9]`` lines): three
     engines, Model 1 fp32 and (c) int8 at replicas=2, the engine hosting
     both killed at a seeded admitted-request index of the Model-1 stream
     (all 2048 test rows once at a Poisson 4000/s, then the (c) stream on
     the recovered placement); every router id resolved exactly once, the
     failures ``WorkerDied`` on the victim's in-flight ids only, both
     models re-placed by live captures (the router's maintenance probe)
     while the stream runs, every served batch of every engine equal to
     eager ``infer_packed`` on its padded group bit for bit, the launch
     counts of each stream those of its replays' captures; p50/p99 and
     images/s beside phase 8's single engine, the walls of the
     re-placements and their captures, the longest blocked submit.  Then a
     cold Model-1 readout learning online on two replicas through the
     router (``feedback_eager=False``): ``reconcile`` (timed) finds them
     equal bit for bit and equal to the offline replay of the same
     feedback; a ``nan-state`` fault on one replica's next fold, and
     ``heal`` (timed) drains, revalidates and repairs it from its peer
     bit for bit, in tensors of its own.
  10. the data-parallel fit (``[phase10]`` lines): while four rank
     processes start on the card (gloo), the DP step's products column
     block by column block against the whole product; then, timed alone on
     the card, on the first 8296 training rows (one unsupervised epoch and
     the readout pass, plain backend): Model 1 DP on 2 and on 4 ranks, (c)
     DP on 2 ranks across a rewire, and a Model-1 DP fit on 2 ranks killed
     by ``WorkerLost`` after its 2nd chunk of 16 batches and resumed on one
     rank over an NCCL group of one.  Every DP fit and the resume equal
     the single-device fits on the card bit for bit (every tensor, mask,
     table, clock and the generator's state: each rank forms the whole
     dense support by the single-device call and keeps its columns); every
     DP-fitted state evaluated through the kernels at the single-device
     state's accuracy; walls, images/s, and a DP step's collectives
     against the rest (processes sharing one card: the protocol, not
     scaling).  Its last check, ``python -m repro_torch.launch.train_dp
     --smoke --device cuda`` in a process of its own (log
     ``chiprun_out/train_dp_smoke.log``), runs beside phase 7's pytest
     process; its lines follow phase 7's.
  4. (run last) where a step's time goes, over 20 steps each of the
     unsupervised step, the readout step and the evaluation batch, dense
     and (c), of (b)'s unsupervised step and evaluation batch, of the
     int8 and bf16 evaluation and served batches of Model 1 and (c), and
     of (b)'s int8 served batch, all eager; and of the unsupervised step,
     readout step and evaluation batch of Model 1, (b) and (c) as the
     epoch programs run them (a replay of the captured step, with the
     host's share between replays); and phase 8's served batches at bucket
     64, eager, as a replay of the bucket's graph, the replay with one
     wait, and with the host copies in and out (``ServeProgram.serve``):
     wall time per step untraced (the median of 5 windows of 20 steps),
     then device-busy time per step from
     ``torch.profiler``, the idle share of the untraced wall time, and the
     kernels that take the most device time.
  11. (after phase 4) the LM zoo's serving path and the BCPNN head
     (``[phase11]`` lines; the ten architectures at smoke size, card
     against CPU, are phase 7's ``test_decode_steps_on_card_match_cpu``):
     qwen1.5-0.5b at its published width and depth in bf16: the
     serve launcher's defaults (batch 4, prompt 32 from ``TokenStream``,
     16 greedy tokens, decode steps under ``set_sync_debug_mode("error")``)
     with prefill ms, decode ms a token and tokens/s, decode logits against
     forward's (``QWEN_REL_TOL`` of the largest logit), one 8 x 2048
     prefill (four query chunks of 512); the BCPNN head (16 x 64 hidden, 10
     classes) on the trunk's mean-pooled features of 128-row batches: one
     unsupervised step with injected noise, one supervised step and a
     prediction, kernels against plain on the card at 1e-4, dense and at
     nact_hi 256, each call's launches as predicted (``HEAD_LAUNCHES``),
     and each call's eager wall.  ``python -m repro_torch.launch.serve
     --arch qwen1.5-0.5b --batch 4 --prompt-len 32 --gen 16`` and ``python
     -m repro_torch.examples.bcpnn_head_on_lm --device cuda`` (its > 0.7
     gate through the kernels) run in processes of their own beside phase
     7 (logs ``chiprun_out/serve_qwen.log``,
     ``chiprun_out/bcpnn_head_on_lm.log``); their lines follow phase 7's.
  12. (``[phase12]`` lines) qwen1.5-0.5b trained on one rank at full
     width: 30 steps, a traced step, repeatable gradients, compressed
     steps; the driver killed and restarted beside phase 7.
  13. (``[phase13]`` lines) the LM zoo on a split mesh: four rank
     processes sharing the card over gloo on (data 2, model 2), each
     holding its quarter of qwen1.5-0.5b at full width (bf16, remat; FSDP
     over data, tensor parallelism over model): one split train step from
     the seed-0 state against the one-rank step on the card (loss, each
     gradient and parameter leaf, at PERF.md section 2's bf16 limits);
     the bytes of parameters, moments and gradients each rank holds
     against what the placements give, and each rank's peak; 4 split
     steps (median ms, tokens/s) and one under the collective meter
     (share and counts); the run killed after its step-2 checkpoint and
     resumed on the same mesh against the uninterrupted run, every rank's
     block bit for bit, and the checkpoint restored on one rank against
     the saved arrays; split prefill (4 x 32) and 16 greedy decode steps
     against one rank (logits at 4 % of the largest, differing tokens
     counted).
  14. (``[phase14]`` lines, after phase 10) Table-1 Models 2 and 3 and
     their -struct presets as published, on ``make_synthetic`` surrogates
     with the datasets' shapes (pneumonia 4708 / 624 rows of 28 x 28,
     breast 546 / 156 of 64 x 64, 2 classes, seed 0): each fitted by
     ``Trainer.fit`` at its paper epochs (20; 100) and batch 64, then
     evaluated (batch 64, 52 for breast), with its launches and rewires
     (every 16 and every 8 steps) as predicted, the graphed fit equal to
     the eager loop bit for bit, test accuracy at least the JAX
     reference's less 0.03 (``JAX_TABLE1_TEST_ACC``); kernel against plain
     single steps from one state (the noisy unsupervised step, the
     readout step, the eval step over the padded tail; the -struct
     presets also in layouts (b) and (c)) within 1e-4; the int8 hidden
     forward against the exact integer accumulators; int8 and bf16 test
     accuracy within phase 6's gate, launches as predicted; replayed
     steps across rewires, int8 packing and serving with no device
     synchronisation.  Phase 4 times their replayed steps.  ``python -m
     repro_torch.examples.medical``, ``.quickstart`` and
     ``.structural_plasticity`` run on the card in processes of their own
     beside phase 7 (logs ``chiprun_out/<name>.log``); their assertions
     must hold, and their lines follow phase 7's.
  15. (``[phase15]`` lines, beside phase 7) the dry run
     (``repro_torch.launch.dryrun``) in three processes of its own with no
     card visible, each a fake group and fake tensors: phase 12's step
     (qwen1.5-0.5b, batch 8 x 256) on one rank, its peak within 20 % of
     phase 12's measured peak over what it held; the same step on phase
     13's (data 2, model 2), its parameter and moment bytes a rank equal to
     phase 13's ranks' exactly and its peak beside each rank's (a ratio);
     and the production cell ``--arch qwen1.5-0.5b --shape train_4k`` on
     (16, 16), which must be ``ok`` under the card machine's torch.  The
     one-rank and (16, 16) records' time terms (the least time on the
     card's peaks, ``launch/roofline.py::analyze``) and bottleneck are
     printed, and the one-rank record's larger of its compute and memory
     terms must be at most phase 12's profiled device-busy time a step at
     the same batch (the ratio printed): a bound above what the card did
     would mean a wrong count.
  7. the ``gpu`` tests of ``tests/test_torch_cuda.py`` in a pytest
     process, their log kept as ``chiprun_out/gpu_tests_<UTC time>.log``
     (each run under its own name); any failure fails the run (the
     kernels over the analysis audit's hostile geometry sweep among them).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# fp32 FLOP/s outside the tensor cores, and dense TF32 and bf16 FLOP/s and
# int8 OP/s of the tensor cores; the dry run's time terms take the same.
from repro_torch.launch.roofline import (PEAK_BF16_FLOP_S,  # noqa: E402
                                         PEAK_BYTES_S, PEAK_FP32_FLOP_S,
                                         PEAK_INT8_OPS_S, PEAK_TF32_FLOP_S,
                                         bcpnn_fwd_traffic)

TIMED_LAUNCHES = 20
TIMED_REPLAYS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn) -> float:
    """Device time of one call of ``fn``: a CUDA graph of TIMED_LAUNCHES
    calls replayed TIMED_REPLAYS times, median per call (launch gaps of the
    host are not in it)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_LAUNCHES):
            fn()
    graph.replay()
    times = []
    for _ in range(TIMED_REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / TIMED_LAUNCHES)
    return statistics.median(times)


def bound(nbytes: float, ops):
    """The least time in ms: the bytes at the memory's rate, or the
    operations, ((count, peak rate), ...), one pair for each unit they run
    on (units run at once, so the slowest sets the time)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(count / peak for count, peak in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1 --

def kernel_cases(torch, gen):
    """(kernel, shape label, kernel call, plain call, library call or None,
    bytes, operations as ((count, peak rate), ...), compare, library call
    of the product alone or None) for every checked shape."""
    from repro_torch.core.bcpnn_layer import topk_mask
    from repro_torch.core.compact import (build_table, gather_dense,
                                          gather_pre, unit_indices)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bcpnn_fwd import cluster_size
    from repro_torch.kernels.hc_softmax import softmax_plan
    from repro_torch.kernels.quant import quant_fwd_plan

    dev = "cuda"
    f32 = torch.float32

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    def close_abs(tol):
        def cmp(got, want):
            err = (got - want).abs().max().item()
            return err, err <= tol
        return cmp

    def close_update(got, want):
        (gp, gw), (wp, ww) = got, want
        err_p = (gp - wp).abs()
        ok_p = bool((err_p <= 1e-9 + 1e-5 * wp.abs()).all())
        err_w = (gw - ww).abs().max().item()
        return max(err_p.max().item(), err_w), ok_p and err_w <= 1e-4

    def close_patchy_update(pij, live_units):
        """close_update, and the silent entries exactly as the layout
        defines them: pij' the input bit for bit, w 0."""
        silent = ~live_units

        def cmp(got, want):
            err, ok = close_update(got, want)
            gp, gw = got
            held = torch.equal(gp[silent], pij[silent]) and \
                bool((gw[silent] == 0).all())
            return err, ok and held
        return cmp

    cases = []

    def add(name, label, kern, plain, lib, nbytes, n_ops, cmp,
            peak=PEAK_FP32_FLOP_S, product=None, fwd_shape=None, note=None,
            traffic=None):
        """n_ops: a count at ``peak``, or ((count, peak rate), ...);
        fwd_shape: a forward's (B, contraction depth, Hj, Mj, bf16,
        layout); note: the kernel's result -> how the kernel took the
        shape (printed), for rows that must also repeat bit for bit;
        traffic: a dense forward's ``bcpnn_fwd_traffic`` arguments (B, Ni,
        Nj, weight dtype, Hj), whose bytes phase 1 holds ``nbytes`` to."""
        ops = n_ops if isinstance(n_ops, tuple) else ((n_ops, peak),)
        if fwd_shape is not None:
            note = lambda got, shape=fwd_shape: \
                f"cluster {cluster_size(*shape)}"
        cases.append((name, label, kern, plain, lib, nbytes, ops, cmp,
                      product, note, traffic))

    def trace_ops(product, epilogue):
        """The resident-trace update's operations: its product in 3xTF32
        on the tensor cores (three TF32 products for each), its EMA and
        fold on the CUDA cores."""
        return ((3 * product, PEAK_TF32_FLOP_S), (epilogue, PEAK_FP32_FLOP_S))

    def fwd_ops(product, epilogue, passes=3):
        """A forward's operations (every layout): its product in 3xTF32 on
        the tensor cores (two TF32 products for a bf16 weight, which is
        exact in TF32), bias, gain and softmax on the CUDA cores."""
        return ((passes * product, PEAK_TF32_FLOP_S),
                (epilogue, PEAK_FP32_FLOP_S))

    def addmm(bias, x, w):
        """The library's fp32 product alone (TF32 off, as the port keeps
        it): a yardstick beside the forward, not a call computing its
        function."""
        return lambda: torch.addmm(bias, x, w)

    def bmm(x, w_c, table, mi):
        """The library's fp32 product alone for a gathered forward: one
        batched product of x's live columns, gathered beforehand as an
        (Hj, B, K) array (the TPU kernels' layout), and the (Hj, K, Mj)
        live weights.  A yardstick like ``addmm``; the gathers are not
        timed."""
        ui = unit_indices(table, mi, sentinel=x.shape[1])
        xg = gather_pre(x, ui).contiguous()
        wg = w_c.float().contiguous()
        return lambda: torch.bmm(xg, wg)

    def softmax_note(s, m):
        def note(got):
            v, lanes, loads = softmax_plan(s, got, m)
            return (f"{lanes} lanes a segment, {v} floats a load, "
                    + (f"{loads} loads a lane" if loads else "three passes"))
        return note

    # "head": the BCPNN head on qwen1.5-0.5b's pooled features (phase 11:
    # 2048 input units, 16 x 64 hidden, 10 classes).
    for label, b, h, m in (("hidden", 128, 32, 128), ("readout", 128, 1, 10),
                           ("ragged", 37, 3, 10), ("narrow", 128, 64, 2),
                           ("head", 128, 16, 64),
                           ("head-readout", 128, 1, 10),
                           ("m2-hidden", 64, 32, 256),
                           ("m2-readout", 64, 1, 2)):
        s = randn(b, h * m) * 4
        lib = (lambda s=s, b=b, h=h, m=m:
               torch.softmax(s.view(b, h, m), dim=-1))
        add("hc_softmax", label,
            lambda s=s, h=h, m=m: ops.hc_softmax(s, h, m),
            lambda s=s, h=h, m=m: ref.ref_hc_softmax(s, h, m),
            lib, 2 * s.numel() * 4, 6 * s.numel(),
            close_abs(2e-6), note=softmax_note(s, m))
    for label, b, ni, hj, mj in (("hidden", 128, 1568, 32, 128),
                                 ("readout", 128, 4096, 1, 10),
                                 ("ragged", 37, 1000, 3, 10),
                                 ("head", 128, 2048, 16, 64),
                                 ("m2-hidden", 64, 1568, 32, 256),
                                 ("m2-readout", 64, 8192, 1, 2),
                                 ("m3-hidden", 64, 8192, 32, 128)):
        x, w, bias = rand(b, ni), randn(ni, hj * mj) * 0.1, randn(hj * mj)
        nj = hj * mj
        add("bcpnn_fwd", label,
            lambda x=x, w=w, bias=bias, hj=hj, mj=mj:
            ops.bcpnn_fwd(x, w, bias, hj, mj),
            lambda x=x, w=w, bias=bias, hj=hj, mj=mj:
            ref.ref_bcpnn_fwd(x, w, bias, hj, mj),
            None, 4 * (b * ni + ni * nj + nj + b * nj),
            fwd_ops(2 * b * ni * nj, 7 * b * nj), close_abs(1e-5),
            product=addmm(bias, x, w),
            fwd_shape=(b, ni, hj, mj, False, "dense"),
            traffic=(b, ni, nj, "fp32", hj))
    # n: genuine rows of a zero-padded tail batch (None: all rows are).
    # a = 1 is the first step of every fit: there pij' is XᵀY/n itself, so
    # an error in the product is not damped by a small smoothing.
    for label, b, n, hi, mi, hj, mj, alpha in (
            ("hidden", 128, None, 784, 2, 32, 128, 2e-3),
            ("hidden-a1", 128, None, 784, 2, 32, 128, 1.0),
            ("readout", 128, None, 32, 128, 1, 10, 2e-3),
            ("tail", 128, 104, 784, 2, 32, 128, 2e-3),
            ("ragged", 37, None, 500, 2, 3, 10, 2e-3),
            ("head", 128, None, 1024, 2, 16, 64, 1e-2),
            ("head-readout", 128, None, 16, 64, 1, 10, 1e-2),
            ("m2-hidden", 64, None, 784, 2, 32, 256, 2e-3),
            ("m2-tail", 64, 36, 784, 2, 32, 256, 2e-3),
            ("m2-readout", 64, None, 32, 256, 1, 2, 2e-3),
            ("m3-hidden", 64, None, 4096, 2, 32, 128, 2e-3),
            ("m3-tail", 64, 34, 4096, 2, 32, 128, 2e-3)):
        ni, nj = hi * mi, hj * mj
        pij = rand(ni, nj) * 0.01 + 1e-5
        lpi = torch.log(rand(ni) * 0.5 + 1e-4)
        lpj = torch.log(rand(nj) * 0.5 + 1e-4)
        x, y = rand(b, ni), rand(b, nj)
        count = None
        if n is not None:
            x[n:], y[n:] = 0.0, 0.0
            count = torch.tensor(float(n), device=dev, dtype=f32)
        mask = (rand(hi, hj) > 0.3).to(f32)
        if label == "ragged":
            mask[:, 0] = 0.0
        a = torch.tensor(alpha, device=dev, dtype=f32)
        args = (pij, lpi, lpj, x, y, mask, a)
        add("bcpnn_update", label,
            lambda args=args, count=count:
            ops.bcpnn_update(*args, count=count),
            lambda args=args, count=count:
            ref.ref_bcpnn_update(*args, count=count),
            None,
            4 * (3 * ni * nj + ni + nj + b * (ni + nj) + hi * hj + 1),
            trace_ops(2 * (n or b) * ni * nj, 10 * ni * nj), close_update)

    # Patchy kernels: Model 1-struct (nact 128 of 784 input HCs, K = 256),
    # its padded tail for the updates, and a ragged shape.  Bytes count the
    # live (Hj, K, Mj) weights once; patchy_update produces full (Ni, Nj)
    # outputs, so it also reads and writes all of pij and w.  The forwards
    # price their product at the TF32 rate (3 products, 2 for bf16), with
    # torch.bmm on pre-gathered operands as the product-only yardstick.
    def struct_forwards(label, x, w, w_c, bias, table, mi, hj, mj, nbytes,
                        n_ops, cmp=close_abs(1e-5)):
        """The patchy and compact forward rows of one shape: w is the
        dense-resident (Ni, Hj*Mj) weight, w_c the compact (Hj, K, Mj)
        one; bf16 if they are."""
        b, k = x.shape[0], table.shape[1] * mi
        bf = w.dtype == torch.bfloat16
        for name, layout, kern, plain in (
                ("patchy_forward", "patchy",
                 lambda: ops.patchy_forward(x, w, bias, table, mi, hj, mj),
                 lambda: ref.ref_patchy_forward(x, w, bias, table, mi, hj,
                                                mj)),
                ("compact_forward", "compact",
                 lambda: ops.compact_forward(x, w_c, bias, table, mi),
                 lambda: ref.ref_compact_forward(x, w_c, bias, table, mi))):
            add(name, label, kern, plain, None, nbytes, n_ops, cmp,
                product=bmm(x, w_c, table, mi),
                fwd_shape=(b, k, hj, mj, bf, layout))

    for label, b, n, hi, mi, hj, mj, nact in (
            ("struct", 128, None, 784, 2, 32, 128, 128),
            ("tail", 128, 104, 784, 2, 32, 128, 128),
            ("ragged", 37, None, 13, 3, 3, 10, 4),
            ("m2-struct", 64, None, 784, 2, 32, 256, 128),
            ("m3-struct", 64, None, 4096, 2, 32, 128, 128)):
        ni, nj, k = hi * mi, hj * mj, nact * mi
        hc_mask = topk_mask(rand(hi, hj), nact)
        table = build_table(hc_mask, nact)
        live_units = hc_mask.repeat_interleave(mi, 0).repeat_interleave(
            mj, 1) > 0
        x, y = rand(b, ni), rand(b, nj)
        count = None
        if n is not None:
            x[n:], y[n:] = 0.0, 0.0
            count = torch.tensor(float(n), device=dev, dtype=f32)
        live = hj * k * mj
        small = 4 * (b * ni + b * nj + hj * nact)  # x, y or out, table
        if n is None:
            w, w_c, bias = randn(ni, nj) * 0.1, randn(hj, k, mj) * 0.1, \
                randn(nj)
            struct_forwards(label, x, w, w_c, bias, table, mi, hj, mj,
                            4 * (live + nj) + small,
                            fwd_ops(2 * b * live, 7 * b * nj))
        lpi = torch.log(rand(ni) * 0.5 + 1e-4)
        lpj = torch.log(rand(nj) * 0.5 + 1e-4)
        a = torch.tensor(2e-3, device=dev, dtype=f32)
        pij, pij_c = rand(ni, nj) * 0.01 + 1e-5, rand(hj, k, mj) * 0.01 + 1e-5
        product, epilogue = 2 * (n or b) * live, 10 * live
        a1 = torch.tensor(1.0, device=dev, dtype=f32)
        # the first-step smoothing (a = 1) at Model 1-struct as well
        alphas = (("", a), ("-a1", a1)) if label == "struct" else (("", a),)
        for suffix, a_p in alphas:
            add(
                "patchy_update", label + suffix,
                lambda p=pij, x=x, y=y, t=table, c=count, lpi=lpi, lpj=lpj,
                a=a_p, mi=mi, hj=hj, mj=mj:
                ops.patchy_update(p, lpi, lpj, x, y, t, a, mi, hj, mj,
                                  count=c),
                lambda p=pij, x=x, y=y, t=table, c=count, lpi=lpi, lpj=lpj,
                a=a_p, mi=mi, hj=hj, mj=mj:
                ref.ref_patchy_update(p, lpi, lpj, x, y, t, a, mi, hj, mj,
                                      count=c),
                None, 4 * (3 * ni * nj + ni + nj) + small,
                trace_ops(product, epilogue),
                close_patchy_update(pij, live_units))
        for suffix, a_c in alphas:
            add(
                "compact_update", label + suffix,
                lambda p=pij_c, x=x, y=y, t=table, c=count, lpi=lpi, lpj=lpj,
                a=a_c, mi=mi:
                ops.compact_update(p, lpi, lpj, x, y, t, a, mi, count=c),
                lambda p=pij_c, x=x, y=y, t=table, c=count, lpi=lpi, lpj=lpj,
                a=a_c, mi=mi:
                ref.ref_compact_update(p, lpi, lpj, x, y, t, a, mi,
                                       count=c),
                None, 4 * (3 * live + ni + nj) + small,
                trace_ops(product, epilogue), close_update)

    # bf16 serving packs through the forward kernels: weights and bias
    # rounded to bf16 (2 bytes each), against the plain forward, which
    # widens them to fp32.
    bf16 = torch.bfloat16
    b, ni, hj, mj = 128, 1568, 32, 128
    nj = hj * mj
    x, w, bias = rand(b, ni), (randn(ni, nj) * 0.1).to(bf16), \
        randn(nj).to(bf16)
    add("bcpnn_fwd", "hidden-bf16",
        lambda x=x, w=w, bias=bias, hj=hj, mj=mj:
        ops.bcpnn_fwd(x, w, bias, hj, mj),
        lambda x=x, w=w, bias=bias, hj=hj, mj=mj:
        ref.ref_bcpnn_fwd(x, w, bias, hj, mj),
        None, 4 * b * ni + 2 * (ni * nj + nj) + 4 * b * nj,
        fwd_ops(2 * b * ni * nj, 7 * b * nj, passes=2), close_abs(1e-5),
        product=addmm(bias.float(), x, w.float()),
        fwd_shape=(b, ni, hj, mj, True, "dense"),
        traffic=(b, ni, nj, "bf16", hj))
    hi, mi, nact = 784, 2, 128
    k, live = nact * mi, hj * nact * mi * mj
    table = build_table(topk_mask(rand(hi, hj), nact), nact)
    w_c = (randn(hj, k, mj) * 0.1).to(bf16)
    small = 4 * (b * ni + b * nj + hj * nact)
    struct_forwards("struct-bf16", x, w, w_c, bias, table, mi, hj, mj,
                    2 * (live + nj) + small,
                    fwd_ops(2 * b * live, 7 * b * nj, passes=2))

    # The int8 kernels: Model 1's hidden layer (dense codes), Model
    # 1-struct (patchy and compact codes) and a ragged shape whose rates
    # leave [0, 1], so the codes clip.  Bytes: fp32 x, 1-byte codes (the
    # live ones for the patchy layouts), fp32 bias, scale and rates;
    # operations: the int8 products at the tensor cores' int8 rate.
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def quant_note(x, w_q, hj, mj, table=None, mi=1):
        def note(got):
            rows, ks = quant_fwd_plan(x, w_q, hj, mj, table, mi)
            return f"s8 tensor cores, tiles of {rows} rows, cluster {ks}"
        return note

    # k8192: x = 1 and every code at +-127, most of a column's of one
    # sign, so the int32 sums pass 2**24; scales keep the supports within a
    # few tens.
    for label, b, ni, hj, mj in (("hidden", 128, 1568, 32, 128),
                                 ("ragged", 37, 1000, 3, 10),
                                 ("k8192", 128, 8192, 4, 128),
                                 ("m2-hidden", 64, 1568, 32, 256),
                                 ("m3-hidden", 64, 8192, 32, 128)):
        nj = hj * mj
        w_q, bias, scale = codes(ni, nj), randn(nj), rand(hj) * 0.02 + 1e-3
        if label == "ragged":
            x = rand(b, ni) * 1.2 - 0.1
        elif label != "k8192":
            x = rand(b, ni)
        else:
            x = torch.ones((b, ni), device=dev, dtype=f32)
            flip = rand(ni, nj) < torch.linspace(0.0, 0.05, nj, device=dev)
            w_q = torch.where(flip, -127, 127).to(torch.int8)
            scale = torch.full((hj,), 2e-5, device=dev, dtype=f32)
        add("quant_fwd", label,
            lambda x=x, w=w_q, bias=bias, sc=scale, hj=hj, mj=mj:
            ops.quant_fwd(x, w, bias, sc, hj, mj),
            lambda x=x, w=w_q, bias=bias, sc=scale, hj=hj, mj=mj:
            ref.ref_quant_fwd(x, w, bias, sc, hj, mj),
            None, 4 * b * ni + ni * nj + 4 * (nj + hj + b * nj),
            2 * b * ni * nj, close_abs(1e-6), peak=PEAK_INT8_OPS_S,
            note=quant_note(x, w_q, hj, mj), traffic=(b, ni, nj, "int8", hj))
    for label, b, hi, mi, hj, mj, nact in (
            ("struct", 128, 784, 2, 32, 128, 128),
            ("ragged", 37, 13, 3, 3, 10, 4),
            ("m2-struct", 64, 784, 2, 32, 256, 128),
            ("m3-struct", 64, 4096, 2, 32, 128, 128)):
        ni, nj, k = hi * mi, hj * mj, nact * mi
        live = hj * k * mj
        table = build_table(topk_mask(rand(hi, hj), nact), nact)
        x = rand(b, ni) * 1.2 - 0.1 if label == "ragged" else rand(b, ni)
        w_q, w_c = codes(ni, nj), codes(hj, k, mj)
        bias, scale = randn(nj), rand(hj) * 0.02 + 1e-3
        for name, w, kern, plain in (
                ("quant_patchy_forward", w_q,
                 lambda x=x, w=w_q, bias=bias, sc=scale, t=table, mi=mi,
                 hj=hj, mj=mj:
                 ops.quant_patchy_forward(x, w, bias, sc, t, mi, hj, mj),
                 lambda x=x, w=w_q, bias=bias, sc=scale, t=table, mi=mi,
                 hj=hj, mj=mj:
                 ref.ref_quant_patchy_forward(x, w, bias, sc, t, mi, hj, mj)),
                ("quant_compact_forward", w_c,
                 lambda x=x, w=w_c, bias=bias, sc=scale, t=table, mi=mi:
                 ops.quant_compact_forward(x, w, bias, sc, t, mi),
                 lambda x=x, w=w_c, bias=bias, sc=scale, t=table, mi=mi:
                 ref.ref_quant_compact_forward(x, w, bias, sc, t, mi))):
            add(name, label, kern, plain, None,
                live + 4 * (b * ni + nj + hj + hj * nact + b * nj),
                2 * b * live, close_abs(1e-6), peak=PEAK_INT8_OPS_S,
                note=quant_note(x, w, hj, mj, table, mi))

    # Model 1's hidden layer with weights at the fitted range of log-odds
    # (log clip(pij) - log pi - log pj from traces of binary-pixel inputs
    # and sharp hidden rates; supports of 10 and more), where an error in
    # the 3xTF32 split would show: held to the plain version and to an
    # fp64 forward, 1e-5 each (the error printed is the larger).
    n, b, hi, hj, mj, eps = 512, 128, 784, 32, 128, 1e-4

    def encode(rows):
        pix = (rand(rows, hi) < 0.3).double()
        return torch.stack([pix, 1.0 - pix], -1).reshape(rows, 2 * hi)

    xf = encode(n)
    proj = torch.randn((2 * hi, hj * mj), generator=gen, device=dev,
                       dtype=torch.float64)
    yf = torch.softmax((xf @ proj * 0.05).view(n, hj, mj), -1).view(n, -1)
    pi, pj, pij = xf.mean(0), yf.mean(0), xf.T @ yf / n
    w = (torch.log(pij.clamp(eps * eps, 1.0))
         - torch.log(pi.clamp(eps, 1.0))[:, None]
         - torch.log(pj.clamp(eps, 1.0))[None, :]).float().contiguous()
    bias = torch.log(pj.clamp(eps, 1.0)).float()
    x = encode(b).float().contiguous()
    s64 = x.double() @ w.double() + bias.double()
    check(s64.abs().max().item() >= 10.0, "fitted log-odds: supports < 10")

    def close_plain_and_fp64(s64, hj, mj):
        """Within 1e-5 of the plain version and of the fp64 rates of the
        fp64 supports ``s64`` (the error printed is the larger)."""
        want64 = torch.softmax(s64.view(b, hj, mj), -1).view(b, -1)

        def cmp(got, want):
            err = max((got - want).abs().max().item(),
                      (got.double() - want64).abs().max().item())
            return err, err <= 1e-5
        return cmp

    nj = hj * mj
    add("bcpnn_fwd", "hidden-fitted",
        lambda x=x, w=w, bias=bias: ops.bcpnn_fwd(x, w, bias, hj, mj),
        lambda x=x, w=w, bias=bias: ref.ref_bcpnn_fwd(x, w, bias, hj, mj),
        None, 4 * (b * 2 * hi + 2 * hi * nj + nj + b * nj),
        fwd_ops(2 * b * 2 * hi * nj, 7 * b * nj),
        close_plain_and_fp64(s64, hj, mj),
        product=addmm(bias, x, w),
        fwd_shape=(b, 2 * hi, hj, mj, False, "dense"),
        traffic=(b, 2 * hi, nj, "fp32", hj))

    # The same fitted weights behind a Model 1-struct table (nact 128 of
    # the 784 input HCs): the gathered forwards held to plain and to the
    # fp64 forward over each post-HC's live rows, 1e-5 each.
    mi, nact = 2, 128
    k, live = nact * mi, hj * nact * mi * mj
    table = build_table(topk_mask(rand(hi, hj), nact), nact)
    ui = unit_indices(table, mi, sentinel=2 * hi)
    w_c = gather_dense(w, ui, hj, mj).contiguous()
    s64 = (torch.einsum("jbk,jkm->bjm", gather_pre(x.double(), ui),
                        w_c.double()).reshape(b, nj) + bias.double())
    check(s64.abs().max().item() >= 10.0,
          "fitted log-odds behind the struct table: supports < 10")
    struct_forwards("struct-fitted", x, w, w_c, bias, table, mi, hj, mj,
                    4 * (live + nj + b * 2 * hi + b * nj + hj * nact),
                    fwd_ops(2 * b * live, 7 * b * nj),
                    close_plain_and_fp64(s64, hj, mj))
    return cases


CU = "src/repro_torch/kernels/csrc/bcpnn.cu"
QU = "src/repro_torch/kernels/csrc/quant.cu"
# kernel -> (source, TPU kernel it replaces, shape label of its main row)
SOURCES = {
    "hc_softmax": (CU, "src/repro/kernels/hc_softmax.py:35", "hidden"),
    "bcpnn_fwd": (CU, "src/repro/kernels/bcpnn_fwd.py:56", "hidden"),
    "bcpnn_update": (CU, "src/repro/kernels/bcpnn_update.py:63", "hidden"),
    "patchy_forward": (CU, "src/repro/kernels/patchy.py:121", "struct"),
    "compact_forward": (CU, "src/repro/kernels/patchy.py:154", "struct"),
    "patchy_update": (CU, "src/repro/kernels/patchy.py:241", "struct"),
    "compact_update": (CU, "src/repro/kernels/patchy.py:289", "struct"),
    "quant_fwd": (QU, "src/repro/kernels/quant.py:175", "hidden"),
    "quant_compact_forward": (QU, "src/repro/kernels/quant.py:267", "struct"),
    "quant_patchy_forward": (QU, "src/repro/kernels/quant.py:317", "struct"),
}


def phase1(torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for name, label, kern, plain, lib, nbytes, ops, cmp, product, \
            note, traffic in kernel_cases(torch, gen):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, ok = cmp(got, want)
        check(ok, f"{name}[{label}] disagrees with its plain version "
                  f"(max abs err {err:.3e})")
        extra = ""
        if note is not None:
            # a cluster sums its partials in a fixed order (the int8 ones
            # exactly): a repeat is the same bit for bit, and a race
            # between the roles would show
            check(all(torch.equal(kern(), got) for _ in range(10)),
                  f"{name}[{label}] differs between identical launches")
            extra = f"  {note(got)}"
        ms = device_ms(kern)
        plain_ms = device_ms(plain)
        lib_ms = device_ms(lib) if lib is not None else None
        bound_ms, bound_by = bound(nbytes, ops)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        if product is not None:
            row["product_library_ms"] = device_ms(product)
            extra += (f"  library, product only "
                     f"{row['product_library_ms'] * 1e3:.2f} us")
        if traffic is not None:
            extra += "  " + traffic_note(name, label, nbytes, traffic)
        print(f"[phase1] {name}[{label}] ok: max_abs_err {err:.3e}  "
              f"kernel {ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f} us  "
              f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}"
              f"  bound {bound_ms * 1e3:.2f} us ({bound_by}){extra}",
              flush=True)
        rows.setdefault(name, {})[label] = row
    int_mm_yardstick(torch, gen, rows["quant_fwd"]["hidden"])
    quant_plan_times(torch, gen, rows)
    fwd_cluster_times(torch, gen, rows["bcpnn_fwd"]["m3-hidden"])
    int8_bmm_check(torch, gen, rows)
    copy_yardstick(torch, gen, rows["bcpnn_update"]["hidden"])
    mma_yardstick(torch, rows["bcpnn_update"]["hidden"])
    return rows


def traffic_note(name, label, nbytes, traffic):
    """A dense forward row's bytes against ``bcpnn_fwd_traffic``'s for the
    same shape and weight dtype (fp32 activations): equal, except that
    the int8 row counts the pack's fp32 bias (4 bytes a unit) where the
    model counts the bias at the weight's width (1 byte)."""
    b, ni, nj, wdt, hj = traffic
    model = bcpnn_fwd_traffic(b, ni, nj, weight_dtype=wdt, n_hc=hj)["bytes"]
    if wdt == "int8":
        check(nbytes == model + 3 * nj,
              f"{name}[{label}]: bytes {nbytes} are not the traffic model's "
              f"{model} with the fp32 bias")
        return (f"bytes {nbytes}, traffic model {model:.0f} (it counts the "
                f"bias at 1 byte, the int8 pack keeps it in fp32: "
                f"{3 * nj} more)")
    check(nbytes == model, f"{name}[{label}]: bytes {nbytes} differ from "
                           f"the traffic model's {model}")
    return f"bytes {nbytes} = traffic model's"


def fwd_cluster_times(torch, gen, row):
    """``bcpnn_fwd`` at Model 3's hidden shape (B 64, 8192 -> 32 x 128)
    under every cluster size the shape allows, each named by an autotune
    cache entry in ``chiprun_out/autotune_phase1.json`` (the variable
    ``REPRO_AUTOTUNE_CACHE`` set for this function only, so a user's
    cache is not touched): the size launched read back, the rates within
    1e-5 of the plain version, and the time of each.  A reading, not a
    claim."""
    from repro_torch.kernels import ops, ref, tuning
    from repro_torch.kernels.bcpnn_fwd import (LAST_CLUSTER, cluster_range,
                                               cluster_size)
    b, ni, hj, mj = 64, 8192, 32, 128
    x = torch.rand((b, ni), generator=gen, device="cuda")
    w = torch.randn((ni, hj * mj), generator=gen, device="cuda") * 0.1
    bias = torch.randn((hj * mj,), generator=gen, device="cuda")
    want = ref.ref_bcpnn_fwd(x, w, bias, hj, mj)
    rule = cluster_size(b, ni, hj, mj)
    lo, hi = cluster_range(b, ni, hj, mj)
    path = ROOT / "chiprun_out" / "autotune_phase1.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    key = tuning.entry_key("bcpnn_fwd", b=b, ni=ni, n_hc=hj, n_mc=mj)
    before = os.environ.get(tuning.ENV_CACHE)
    os.environ[tuning.ENV_CACHE] = str(path)
    times = {}
    try:
        for ks in range(lo, hi + 1):
            tuning.save_entries({key: {"cluster": ks}})
            os.utime(path, (ks, ks))  # a new mtime, whatever the clock's grain
            got = ops.bcpnn_fwd(x, w, bias, hj, mj)
            check(LAST_CLUSTER["bcpnn_fwd"] == ks,
                  f"bcpnn_fwd[m3-hidden]: the cache named cluster {ks}, the "
                  f"launch took {LAST_CLUSTER['bcpnn_fwd']}")
            err = (got - want).abs().max().item()
            check(err <= 1e-5, f"bcpnn_fwd[m3-hidden] at cluster {ks}: max "
                               f"abs err {err:.3e} from the plain version")
            times[ks] = device_ms(lambda: ops.bcpnn_fwd(x, w, bias, hj, mj))
    finally:
        if before is None:
            os.environ.pop(tuning.ENV_CACHE)
        else:
            os.environ[tuning.ENV_CACHE] = before
    row["cluster_ms"] = times
    print(f"[phase1] bcpnn_fwd[m3-hidden] by cluster size, each named by "
          f"the autotune cache ({path.relative_to(ROOT)}; the search takes "
          f"{rule}; rates within 1e-5 of plain under each): "
          + ", ".join(f"{ks}: {ms * 1e3:.2f} us" for ks, ms in times.items()),
          flush=True)


def mma_yardstick(torch, row):
    """The throughput of the update's 3xTF32 ``mma.sync`` pattern on
    register operands (``csrc/yardstick.cu``: no memory traffic), with the
    operands split in every step as the kernel splits them, and split
    once; and how long Model 1's product (3 x 2·B·Ni·Nj FLOP) takes at the
    first rate.  A yardstick only (``library_ms`` stays null)."""
    from repro_torch.kernels import _build
    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    iters = 1000
    flop = 2048.0 * 24 * 16 * iters * sms  # 24 mma a step, 16 warps an SM
    for split, key in ((1, "mma_split_flop_s"), (0, "mma_fixed_flop_s")):
        ms = device_ms(lambda split=split: _build.check_launch(
            lib.bcpnn_mma_tf32_rate(out.data_ptr(), sms, iters, split,
                                    _build.stream_ptr(out)),
            "mma_tf32_rate"))
        row[key] = flop / (ms * 1e-3)
    row["mma_split_product_ms"] = \
        3 * 2 * 128 * 1568 * 4096 / row["mma_split_flop_s"] * 1e3
    print(f"[phase1] yardstick: mma.sync m16n8k8 TF32 in the update's "
          f"3xTF32 pattern, 16 warps an SM: "
          f"{row['mma_split_flop_s'] / 1e12:.1f} TFLOP/s with the operands "
          f"split every step, "
          f"{row['mma_fixed_flop_s'] / 1e12:.1f} split once; at the first "
          f"rate Model 1's product takes "
          f"{row['mma_split_product_ms'] * 1e3:.2f} us", flush=True)


def copy_yardstick(torch, gen, row):
    """A plain device copy of Model 1's (1568, 4096) fp32 trace: what the
    card's memory delivers to a streaming kernel, beside the update's
    bytes bound (which counts the data sheet's 3.35 TB/s).  A yardstick
    only (``library_ms`` stays null)."""
    src = torch.rand((1568, 4096), generator=gen, device="cuda")
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src))
    moved = 2 * src.numel() * 4
    row["copy_ms"] = ms
    row["copy_bytes_s"] = moved / (ms * 1e-3)
    print(f"[phase1] yardstick: a {moved / 1e6:.1f} MB device copy takes "
          f"{ms * 1e3:.2f} us ({row['copy_bytes_s'] / 1e12:.3f} TB/s); at that "
          f"rate the update's {3 * src.numel() * 4 / 1e6:.1f} MB of trace "
          f"traffic take {1.5 * ms * 1e3:.2f} us", flush=True)


def quant_plan_times(torch, gen, rows):
    """The int8 forwards at Model 1 (dense) and Model 1-struct (patchy,
    compact) with the plan forced: tiles of 64 or 128 rows, clusters of 1
    to 4 blocks.  The time of each (what the launcher's rule is set from),
    and the same rates bit for bit under every plan (integer partial
    sums)."""
    from repro_torch.core.bcpnn_layer import topk_mask
    from repro_torch.core.compact import build_table
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant import quant_fwd_plan
    b, hi, mi, hj, mj, nact = 128, 784, 2, 32, 128, 128
    ni, nj = hi * mi, hj * mj
    dev = "cuda"
    table = build_table(topk_mask(torch.rand((hi, hj), generator=gen,
                                             device=dev), nact), nact)
    x = torch.rand((b, ni), generator=gen, device=dev)
    bias = torch.randn((nj,), generator=gen, device=dev)
    scale = torch.rand((hj,), generator=gen, device=dev) * 0.02 + 1e-3
    w_q = torch.randint(-127, 128, (ni, nj), generator=gen, device=dev,
                        dtype=torch.int8)
    w_c = torch.randint(-127, 128, (hj, nact * mi, mj), generator=gen,
                        device=dev, dtype=torch.int8)
    for name, label, tbl, w, call in (
            ("quant_fwd", "hidden", None, w_q,
             lambda **kw: ops.quant_fwd(x, w_q, bias, scale, hj, mj, **kw)),
            ("quant_patchy_forward", "struct", table, w_q,
             lambda **kw: ops.quant_patchy_forward(x, w_q, bias, scale, table,
                                                   mi, hj, mj, **kw)),
            ("quant_compact_forward", "struct", table, w_c,
             lambda **kw: ops.quant_compact_forward(x, w_c, bias, scale,
                                                    table, mi, **kw))):
        plan = quant_fwd_plan(x, w, hj, mj, tbl, mi)
        first = call()
        times = {}
        for tile in (64, 128):
            for ks in (1, 2, 3, 4):
                check(torch.equal(call(rows=tile, cluster=ks), first),
                      f"{name}[{label}] with tiles of {tile} rows, cluster "
                      f"{ks}, differs from its own plan {plan}")
                times[f"{tile}x{ks}"] = device_ms(
                    lambda tile=tile, ks=ks: call(rows=tile, cluster=ks))
        rows[name][label]["plan_ms"] = times
        print(f"[phase1] {name}[{label}] by plan (tile rows x cluster; the "
              f"rule takes {plan[0]}x{plan[1]}; rates equal bit for bit under "
              f"every plan): "
              + ", ".join(f"{k}: {ms * 1e3:.2f} us" for k, ms in times.items()),
              flush=True)


def int8_bmm_check(torch, gen, rows):
    """Whether ``torch.bmm`` multiplies int8 codes on the card, at the
    gathered forwards' pre-gathered (Hj, B, K) x (Hj, K, Mj) shapes of
    Model 1-struct: the one library call that could time their product
    alone.  Timed where it runs; the refusal printed where it does not."""
    xg = torch.randint(0, 128, (32, 128, 256), generator=gen, device="cuda",
                       dtype=torch.int8)
    wg = torch.randint(-127, 128, (32, 256, 128), generator=gen,
                       device="cuda", dtype=torch.int8)
    try:
        torch.bmm(xg, wg)
    except (RuntimeError, NotImplementedError) as e:
        answer = f"refused ({type(e).__name__}: {str(e).splitlines()[0]})"
    else:
        ms = device_ms(lambda: torch.bmm(xg, wg))
        for name in ("quant_patchy_forward", "quant_compact_forward"):
            rows[name]["struct"]["product_library_ms"] = ms
        answer = f"runs, {ms * 1e3:.2f} us"
    print(f"[phase1] yardstick: torch.bmm on int8 (32, 128, 256) x "
          f"(32, 256, 128) codes: {answer}", flush=True)


def int_mm_yardstick(torch, gen, row):
    """``torch._int_mm`` on quant_fwd's Model-1 operands: the int8 product
    alone (codes in, int32 sums out; no quantization, dequant or softmax),
    a yardstick for the product's share, not a library call computing the
    kernel's function (``library_ms`` stays null).  Timed with the codes
    row-major, as the packs hold them, and column-major, the layout the
    int8 GEMMs of cuBLASLt take without a transpose."""
    from repro_torch.kernels.quant import quantize_acts
    a = quantize_acts(torch.rand((128, 1568), generator=gen, device="cuda"))
    b = torch.randint(-127, 128, (1568, 4096), generator=gen, device="cuda",
                      dtype=torch.int8)
    b_cols = b.t().contiguous().t()
    row["int_mm_ms"] = device_ms(lambda: torch._int_mm(a, b))
    row["int_mm_col_major_ms"] = device_ms(lambda: torch._int_mm(a, b_cols))
    print(f"[phase1] yardstick: torch._int_mm (128x1568 @ 1568x4096 int8, "
          f"the product alone) {row['int_mm_ms'] * 1e3:.2f} us, with the "
          f"codes column-major {row['int_mm_col_major_ms'] * 1e3:.2f} us",
          flush=True)


# --------------------------------------------------------------- phase 2 --

def phase2(torch):
    from repro_torch.configs.bcpnn_models import MODEL1_MNIST
    from repro_torch.core import Trainer
    from repro_torch.data.synthetic import encode_images, make_synthetic
    from repro_torch.kernels import ops

    t = time.perf_counter()
    ds = make_synthetic(n_train=16384, n_test=2048, side=28, n_classes=10,
                        seed=0)
    xtr, ytr = encode_images(ds.x_train), ds.y_train
    xte, yte = encode_images(ds.x_test), ds.y_test
    print(f"[phase2] data {xtr.shape} + {xte.shape} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    ops.reset_launch_counts()
    t = time.perf_counter()
    tr = Trainer(MODEL1_MNIST, seed=0, device="cuda")
    stats = tr.fit(xtr, ytr, epochs=5, batch=128)
    t_fit = time.perf_counter() - t
    t = time.perf_counter()
    acc_train = tr.evaluate(xtr, ytr)
    acc_test = tr.evaluate(xte, yte)
    t_eval = time.perf_counter() - t
    launches = ops.launch_counts()
    print(f"[phase2] Model 1 fit: unsup_s {stats['unsup_s']:.4f}  "
          f"sup_s {stats['sup_s']:.4f}  train_ms_per_img "
          f"{stats['train_ms_per_img']:.6f}  (fit {t_fit:.3f} s incl. "
          f"init, eval {t_eval:.3f} s for {len(xtr) + len(xte)} images)",
          flush=True)
    print(f"[phase2] accuracy train {acc_train:.4f} test {acc_test:.4f}; "
          f"launches {json.dumps(launches)}", flush=True)
    check(acc_test > 0.85, f"Model-1 test accuracy {acc_test:.4f} <= 0.85")
    want = {name: MODEL1_LAUNCHES.get(name, 0) for name in launches}
    check(launches == want, f"the Model-1 fit and evaluation launched "
                            f"{launches}, predicted {want}")
    graphed_vs_eager(torch, "[phase2] Model 1", tr, stats, MODEL1_MNIST,
                     xtr, ytr, xte, yte)
    tail_fit(torch, xtr, ytr)
    return tr, (xtr, ytr, xte, yte), launches


# Launches of the Model-1 fit (5 epochs of 128 steps, the readout pass of
# 128) and its evaluation (128 + 16 batches); unnamed kernels: 0.
MODEL1_LAUNCHES = {"bcpnn_fwd": 272, "bcpnn_update": 768, "hc_softmax": 784}


def eager_fit(torch, cfg, xtr, ytr, epochs=5, batch=128, seed=0):
    """The fit as the loop of functional (not donated) steps that
    ``Trainer.fit``'s epoch programs replay, from the same seed: whole
    batches the plain step, a padded tail the masked one.  Returns the
    state, ``unsup_s`` and ``sup_s`` (host clock, ending in a
    synchronize)."""
    import numpy as np
    from repro_torch.core import Trainer
    from repro_torch.core.bcpnn_layer import forward
    from repro_torch.core.network import (supervised_readout_step,
                                          train_projection_step)
    from repro_torch.core.trainer import _batchify_padded
    tr = Trainer(cfg, seed=seed, device="cuda")
    spec, st = tr.spec, tr.state
    xs_np, valid_np = _batchify_padded(np.asarray(xtr, np.float32), batch)
    ys_np, _ = _batchify_padded(np.asarray(ytr, np.int32), batch)
    xs, ys, valid = (torch.from_numpy(a).cuda()
                     for a in (xs_np, ys_np, valid_np))
    nb = xs.shape[0]
    tail = nb - 1 if valid_np.min() < 1 else -1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur = xs
    for layer in range(spec.depth):
        for _ in range(epochs):
            for b in range(nb):
                st = train_projection_step(
                    st, spec, cur[b], layer,
                    valid=valid[b] if b == tail else None)
        if layer + 1 < spec.depth:
            cur = torch.stack([forward(st.projs[layer], spec.projs[layer], h)
                               for h in cur])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for b in range(nb):
        st = supervised_readout_step(st, spec, xs[b], ys[b],
                                     valid=valid[b] if b == tail else None)
    torch.cuda.synchronize()
    return st, t1 - t0, time.perf_counter() - t1


def eager_accuracy(torch, state, spec, x, y, batch=128) -> float:
    """``evaluate``'s accuracy from eager functional ``infer`` calls,
    accumulated as the eval program accumulates it."""
    from repro_torch.core.network import infer
    from repro_torch.core.trainer import _eval_data
    xs, ys, valid = _eval_data(x, y, batch, state.device)
    correct = torch.zeros((), dtype=torch.float32, device=state.device)
    total = torch.zeros_like(correct)
    for b in range(xs.shape[0]):
        _, pred = infer(state, spec, xs[b], valid=valid[b])
        correct.add_(((pred == ys[b]).to(torch.float32) * valid[b]).sum())
        total.add_(valid[b].sum())
    return float(correct / torch.clamp_min(total, 1.0))


def state_identity(torch, a, b):
    """(largest absolute difference over every tensor of two states, the
    number of tensors, whether every mask, table and clock mirror is
    equal)."""
    from repro_torch.core.graphs import state_tensors
    ta, tb = state_tensors(a), state_tensors(b)
    worst = max((x.double() - y.double()).abs().max().item()
                for x, y in zip(ta, tb))
    same = len(ta) == len(tb) and all(
        torch.equal(p.mask, q.mask)
        and (p.table is None) == (q.table is None)
        and (p.table is None or torch.equal(p.table, q.table))
        and p.traces.t_host == q.traces.t_host
        for p, q in zip(a.projs + (a.readout,), b.projs + (b.readout,)))
    return worst, len(ta), same


def graphed_vs_eager(torch, label, tr, stats, cfg, xtr, ytr, xte, yte,
                     epochs=5, batch=128, eval_batch=128):
    """A graphed fit (``tr``, fitted by ``Trainer.fit``) against the eager
    loop of the same steps from the same seed: the same state bit for bit,
    masks and tables equal, and ``evaluate`` through ``eval_batches``
    equal to the eager accuracy.  Launches here are no fit's: the counts
    are left as they were."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    state, unsup_s, sup_s = eager_fit(torch, cfg, xtr, ytr, epochs, batch)
    worst, n, same = state_identity(torch, tr.state, state)
    acc_g = tr.evaluate(xte, yte, batch=eval_batch)
    acc_e = eager_accuracy(torch, state, tr.spec, xte, yte, eval_batch)
    ops.set_launch_counts(counts)
    print(f"{label} graphed vs eager fit: unsup_s {stats['unsup_s']:.4f} "
          f"vs {unsup_s:.4f}, sup_s {stats['sup_s']:.4f} vs {sup_s:.4f}; "
          f"state max abs diff {worst:.3e} over {n} arrays, masks, tables "
          f"and clocks {'equal' if same else 'DIFFER'}; test accuracy "
          f"through eval_batches {acc_g:.6f}, eager {acc_e:.6f}",
          flush=True)
    check(worst == 0 and same, f"{label}: the graphed fit parts from the "
                               f"eager loop (max abs diff {worst:.3e}, "
                               f"masks and tables equal: {same})")
    check(acc_g == acc_e, f"{label}: evaluate gives {acc_g}, the eager "
                          f"loop {acc_e}")


def state_diff(a, b) -> float:
    """Largest absolute difference over every trace, weight and bias of
    two DeepStates."""
    import numpy as np
    from repro_torch.convert import state_to_numpy
    a, b = state_to_numpy(a), state_to_numpy(b)
    worst = 0.0
    for pa, pb in zip(a["projs"] + [a["readout"]], b["projs"] + [b["readout"]]):
        for k in ("pi", "pj", "pij"):
            worst = max(worst, float(np.abs(pa["traces"][k]
                                            - pb["traces"][k]).max()))
        for k in ("w", "b"):
            worst = max(worst, float(np.abs(pa[k] - pb[k]).max()))
    return worst


def tail_fit(torch, xtr, ytr):
    """Model 1 on 1000 images at batch 128 (7 whole batches and a 104-row
    tail), one epoch: every step launches the update kernel, the masked
    tail's too.  Then one masked unsupervised step (the same noise
    injected) and one masked readout step from the fitted state, kernels
    against the plain backend, within 1e-4.  Two whole fits are not
    compared: the early running-mean steps amplify fp32 rounding 10-100x
    a step, so fits on the two backends part after a few steps."""
    from repro_torch.configs.bcpnn_models import MODEL1_MNIST
    from repro_torch.core import Trainer
    from repro_torch.core.network import (supervised_readout_step,
                                          train_projection_step)
    from repro_torch.kernels import ops

    n, batch = 1000, 128
    steps = 2 * -(-n // batch)  # one unsupervised epoch + the readout pass
    ops.reset_launch_counts()
    tr = Trainer(MODEL1_MNIST, seed=0, device="cuda")
    tr.fit(xtr[:n], ytr[:n], epochs=1, batch=batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"[phase2] tail fit ({n} images, batch {batch}): launches "
          f"{json.dumps(launches)} over {steps} steps", flush=True)
    check(launches["bcpnn_update"] == steps,
          f"bcpnn_update launched {launches['bcpnn_update']} times in a "
          f"{steps}-step fit with a padded tail")

    dev, spec, state = tr.device, tr.spec, tr.state
    spec_plain = spec.with_backend("torch")
    x = torch.zeros((batch, xtr.shape[1]), dtype=torch.float32, device=dev)
    y = torch.zeros((batch,), dtype=torch.int32, device=dev)
    tail = n % batch
    x[:tail] = torch.from_numpy(xtr[n - tail:n]).to(dev)
    y[:tail] = torch.from_numpy(ytr[n - tail:n]).to(dev)
    valid = (torch.arange(batch, device=dev) < tail).to(torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    noise = torch.randn((batch, spec.projs[0].post.N), generator=gen,
                        device=dev)
    for name, step in (
            ("unsupervised", lambda sp: train_projection_step(
                state, sp, x, 0, valid=valid, noise=noise)),
            ("readout", lambda sp: supervised_readout_step(
                state, sp, x, y, valid=valid))):
        worst = state_diff(step(spec), step(spec_plain))
        print(f"[phase2] masked {name} step on the {tail}-row tail: kernel "
              f"vs plain state max abs diff {worst:.3e}", flush=True)
        check(worst <= 1e-4, f"masked {name} steps differ by {worst:.3e} "
                             f"> 1e-4")


# --------------------------------------------------------------- phase 3 --

def phase3(torch, tr, xte, yte):
    from repro_torch.core.network import (infer, online_learn_step,
                                          stack_rates)

    dev = tr.device
    spec, state = tr.spec, tr.state
    spec_plain = spec.with_backend("torch")

    # a request bucket: 5 genuine rows zero-padded to 8
    xb = torch.zeros((8, xte.shape[1]), dtype=torch.float32, device=dev)
    xb[:5] = torch.from_numpy(xte[:5]).to(dev)
    valid = (torch.arange(8, device=dev) < 5).to(torch.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs, pred = infer(state, spec, xb, valid)
    torch.cuda.synchronize()
    t_req = time.perf_counter() - t
    check(bool((probs[5:] == 0).all()), "pad rows carry probability")
    check(bool((pred[5:] == -1).all()), "pad rows carry a prediction")
    _, pred5 = infer(state, spec, xb[:5])
    check(bool((pred[:5] == pred5).all()), "padding changed a prediction")
    print(f"[phase3] bucket of 8 (5 valid) served in {t_req * 1e3:.3f} ms: "
          f"pad rows zeroed, preds {pred.tolist()}", flush=True)

    x = torch.from_numpy(xte).to(dev)
    # The hidden rates are not saturated, unlike the fitted readout's
    # probs.  Fitted log-odds weights are large, so two fp32 summation
    # orders over Ni terms part by more than phase 1's 1e-5: each path is
    # held against an fp64 version, and the kernel may be no further from
    # it than twice the plain (cuBLAS) path, or 1e-5.
    proj, pspec = state.projs[0], spec.projs[0]
    s64 = proj.b.double() + x.double() @ proj.w.double()
    r64 = torch.softmax(s64.view(len(x), pspec.post.H, pspec.post.M) *
                        pspec.gain, dim=-1).view(len(x), -1)
    hk = stack_rates(state, spec, x)
    hp = stack_rates(state, spec_plain, x)
    err_k = (hk.double() - r64).abs().max().item()
    err_p = (hp.double() - r64).abs().max().item()
    err_kp = (hk - hp).abs().max().item()
    print(f"[phase3] hidden rates on {len(xte)} rows, max abs err vs fp64: "
          f"kernel {err_k:.3e}, plain {err_p:.3e}; kernel vs plain "
          f"{err_kp:.3e}", flush=True)
    check(err_k <= max(1e-5, 2 * err_p),
          f"kernel hidden rates {err_k:.3e} from fp64, plain {err_p:.3e}")
    pk, qk = infer(state, spec, x)
    pp, qp = infer(state, spec_plain, x)
    err = (pk - pp).abs().max().item()
    agree = (qk == qp).float().mean().item()
    print(f"[phase3] kernel vs plain infer on {len(xte)} rows: max abs err "
          f"{err:.3e}, pred agreement {agree:.6f}", flush=True)
    check(err <= 1e-4, f"served probs differ by {err:.3e} > 1e-4")
    check(agree >= 0.999, f"served preds agree on only {agree:.6f}")

    xf = torch.from_numpy(xte[:128]).to(dev)
    yf = torch.from_numpy(yte[:128]).to(dev)
    for learn_stack in (False, True):
        worst = state_diff(
            online_learn_step(state, spec, xf, yf, learn_stack=learn_stack),
            online_learn_step(state, spec_plain, xf, yf,
                              learn_stack=learn_stack))
        print(f"[phase3] feedback fold learn_stack={learn_stack}: kernel vs "
              f"plain state max abs diff {worst:.3e}", flush=True)
        check(worst <= 1e-4, f"folded states differ by {worst:.3e} > 1e-4")


# --------------------------------------------------------------- phase 5 --

# Test accuracy of the JAX package's own Model 1-struct fit in the compact
# layout (jnp backend, on the CPU; same data, seed and protocol), printed by
# ``python tests/test_torch_compact.py --reference-accuracy``.  The two
# packages draw different random numbers, so only accuracy compares; the
# port's (c) fit must reach it less ACC_SLACK.
JAX_REFERENCE_TEST_ACC = 1.0
ACC_SLACK = 0.03
# Two rewire decisions may differ only between pre-HCs whose mutual
# information is this close: trace differences of ~1e-6 reorder near-ties,
# and silent pairs sit at MI 0 up to rounding.
MI_TIE_TOL = 1e-5

STRUCT_VARIANTS = {  # label -> MODEL1_MNIST_STRUCT fields
    "c": dict(patchy_traces=True, compact=True),
    "b": dict(patchy_traces=True),
    "a": {},
}
# Launches of one fit (5 epochs of 128 steps, the readout pass of 128, and
# evaluation of 128 + 16 batches), per variant; unnamed kernels: 0.
STRUCT_LAUNCHES = {
    "c": {"compact_update": 640, "compact_forward": 272,
          "bcpnn_update": 128, "hc_softmax": 784},
    "b": {"patchy_update": 640, "patchy_forward": 272,
          "bcpnn_update": 128, "hc_softmax": 784},
    "a": {"patchy_forward": 272, "bcpnn_update": 768, "hc_softmax": 784},
}


# Rewires in one fit: 640 unsupervised steps, one every 64.
STRUCT_REWIRES = 10


def struct_cfg(variant):
    import dataclasses
    from repro_torch.configs.bcpnn_models import MODEL1_MNIST_STRUCT
    return dataclasses.replace(MODEL1_MNIST_STRUCT, **STRUCT_VARIANTS[variant])


def check_masks(tr, mask0, version0, variant, rewires=STRUCT_REWIRES):
    """Exactly nact live pre-HCs per post-HC, a state that passes the
    deployment guard, and evidence that the rewires ran: the fit's epoch
    programs donate the state, so each rewire writes its mask into the
    one mask tensor, whose version counter counts the writes."""
    from repro_torch.core.bcpnn_layer import validate_patchy_state
    proj, pspec = tr.state.projs[0], tr.spec.projs[0]
    per_col = proj.mask.sum(dim=0)
    check(bool((per_col == pspec.nact).all()),
          f"({variant}) mask columns hold {per_col.unique().tolist()} "
          f"pre-HCs, not exactly {pspec.nact}")
    validate_patchy_state(proj, pspec, where=f"({variant}) fitted stack")
    moved = int((proj.mask != mask0).sum().item()) // 2
    check(proj.traces.t_host == int(proj.traces.t.item()),
          f"({variant}) host clock {proj.traces.t_host} != device clock")
    writes = proj.mask._version - version0
    check(writes == rewires, f"({variant}) the mask was written by "
                             f"{writes} rewires, not {rewires}")
    if variant != "c":
        check(moved > 0, f"({variant}) {rewires} rewires moved no pre-HC")
    return moved


def struct_fits(torch, xtr, ytr, xte, yte):
    """The three layouts' fits; returns the (c) trainer and launches."""
    from repro_torch.core import Trainer
    from repro_torch.kernels import ops

    fitted, launches = {}, {}
    for variant in STRUCT_VARIANTS:
        ops.reset_launch_counts()
        t = time.perf_counter()
        tr = Trainer(struct_cfg(variant), seed=0, device="cuda")
        mask0 = tr.state.projs[0].mask.clone()
        version0 = tr.state.projs[0].mask._version
        stats = tr.fit(xtr, ytr, epochs=5, batch=128)
        t_fit = time.perf_counter() - t
        acc_train = tr.evaluate(xtr, ytr)
        acc_test = tr.evaluate(xte, yte)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        moved = check_masks(tr, mask0, version0, variant)
        print(f"[phase5] ({variant}) Model 1-struct fit: unsup_s "
              f"{stats['unsup_s']:.4f}  sup_s {stats['sup_s']:.4f}  "
              f"train_ms_per_img {stats['train_ms_per_img']:.6f}  (fit "
              f"{t_fit:.3f} s incl. init); accuracy train {acc_train:.4f} "
              f"test {acc_test:.4f}; {moved} pre-HCs rewired; launches "
              f"{json.dumps(got)}", flush=True)
        want = {name: STRUCT_LAUNCHES[variant].get(name, 0) for name in got}
        check(got == want, f"({variant}) launches {got}, predicted {want}")
        graphed_vs_eager(torch, f"[phase5] ({variant})", tr, stats,
                         struct_cfg(variant), xtr, ytr, xte, yte)
        fitted[variant], launches[variant] = tr, got
    floor = JAX_REFERENCE_TEST_ACC - ACC_SLACK
    acc_c = fitted["c"].evaluate(xte, yte)
    check(acc_c >= floor, f"(c) test accuracy {acc_c:.4f} < {floor:.4f} "
                          f"(JAX reference {JAX_REFERENCE_TEST_ACC} less "
                          f"{ACC_SLACK})")
    return fitted, launches


def no_sync_steps(torch, variant, xtr, ytr):
    """70 unsupervised steps from a fresh state (across the rewire at
    clock 64), a masked step, a readout step and an online fold, with any
    implicit device synchronisation an error."""
    from repro_torch.core import Trainer
    from repro_torch.core.network import (online_learn_step,
                                          supervised_readout_step,
                                          train_projection_step)
    fresh = Trainer(struct_cfg(variant), seed=1, device="cuda")
    spec, state = fresh.spec, fresh.state
    x = torch.from_numpy(xtr[:128]).cuda()
    y = torch.from_numpy(ytr[:128]).cuda()
    valid = (torch.arange(128, device="cuda") < 100).to(torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(70):
            state = train_projection_step(state, spec, x, 0)
        state = train_projection_step(state, spec, x, 0, valid=valid)
        state = supervised_readout_step(state, spec, x, y)
        state = online_learn_step(state, spec, x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(state.projs[0].traces.t_host == 72, f"({variant}) clock mirror off")


def no_sync_replays(torch, variant, xtr, ytr):
    """The epoch programs' captured steps, captured on a fresh state at
    their first batch, then replayed with any implicit device
    synchronisation an error: 69 unsupervised steps across the rewire at
    clock 64, two readout steps and two eval batches."""
    from repro_torch.core import Trainer
    fresh = Trainer(struct_cfg(variant), seed=1, device="cuda")
    n = 70
    xs = torch.from_numpy(xtr[:128 * n]).cuda().view(n, 128, -1)
    ys = torch.from_numpy(ytr[:128 * n]).cuda().view(n, 128)
    valid = torch.ones((2, 128), device="cuda")
    unsup, sup, ev = fresh._unsup_fn(0, False), fresh._sup_fn(False), \
        fresh._eval_fn()
    fresh.state = unsup(fresh.state, xs[:1])
    fresh.state = sup(fresh.state, xs[:1], ys[:1])
    ev(fresh.state, xs[:1], ys[:1], valid[:1])
    mask = fresh.state.projs[0].mask.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fresh.state = unsup(fresh.state, xs[1:])
        fresh.state = sup(fresh.state, xs[:2], ys[:2])
        acc = ev(fresh.state, xs[:2], ys[:2], valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    proj = fresh.state.projs[0]
    check(proj.traces.t_host == n == int(proj.traces.t.item()),
          f"({variant}) clock mirror {proj.traces.t_host} after {n} steps")
    check(0.0 <= float(acc) <= 1.0, f"({variant}) eval replay gave {acc}")
    return int((proj.mask != mask).sum().item()) // 2


def struct_tail_fit(torch, xtr, ytr):
    """(c) on 1000 images at batch 128: 8 unsupervised steps, the last a
    masked 104-row tail, each one compact_update launch."""
    from repro_torch.core import Trainer
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    tr = Trainer(struct_cfg("c"), seed=0, device="cuda")
    tr.fit(xtr[:1000], ytr[:1000], epochs=1, batch=128)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    print(f"[phase5] (c) tail fit (1000 images, batch 128): launches "
          f"{json.dumps(got)}", flush=True)
    check(got["compact_update"] == 8,
          f"compact_update launched {got['compact_update']} times in 8 "
          f"unsupervised steps with a padded tail")


def dense_mi(proj, pspec):
    """(Hi, Hj) mutual information of a projection's traces, densified
    for the compact layout."""
    from repro_torch.core.compact import densify_pij
    from repro_torch.core.traces import Traces, mutual_information
    tr = proj.traces
    pij = tr.pij
    if pij.dim() == 3:
        pij = densify_pij(pij, tr.pi, tr.pj, proj.table, pspec.pre.M)
    return mutual_information(Traces(pi=tr.pi, pj=tr.pj, pij=pij, t=tr.t,
                                     t_host=tr.t_host),
                              pspec.pre.H, pspec.pre.M, pspec.post.H,
                              pspec.post.M, pspec.eps)


def struct_single_steps(torch, fitted, xtr, ytr):
    """Kernel backend against plain from one shared state per layout: a
    masked unsupervised step (noise injected), and an online fold from
    trace clock 63 whose learn crosses the rewire at 64."""
    import dataclasses
    from repro_torch.core.bcpnn_layer import forward, learn
    from repro_torch.core.network import (online_learn_step,
                                          train_projection_step)
    dev = "cuda"
    batch, tail = 128, 104
    x = torch.zeros((batch, xtr.shape[1]), dtype=torch.float32, device=dev)
    y = torch.zeros((batch,), dtype=torch.int32, device=dev)
    x[:tail] = torch.from_numpy(xtr[:tail]).to(dev)
    y[:tail] = torch.from_numpy(ytr[:tail]).to(dev)
    valid = (torch.arange(batch, device=dev) < tail).to(torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for variant, tr in fitted.items():
        spec, state = tr.spec, tr.state
        plain = spec.with_backend("torch")
        noise = torch.randn((batch, spec.projs[0].post.N), generator=gen,
                            device=dev)
        worst = state_diff(
            train_projection_step(state, spec, x, 0, valid=valid,
                                  noise=noise),
            train_projection_step(state, plain, x, 0, valid=valid,
                                  noise=noise))
        print(f"[phase5] ({variant}) masked unsupervised step: kernel vs "
              f"plain max abs diff {worst:.3e}", flush=True)
        check(worst <= 1e-4, f"({variant}) masked steps differ by "
                             f"{worst:.3e} > 1e-4")
        p = state.projs[0]
        at63 = dataclasses.replace(state, projs=(dataclasses.replace(
            p, traces=dataclasses.replace(
                p.traces, t=torch.full_like(p.traces.t, 63), t_host=63)),))
        xf = torch.from_numpy(xtr[:batch]).to(dev)
        yf = torch.from_numpy(ytr[:batch]).to(dev)
        sk = online_learn_step(at63, spec, xf, yf)
        sp = online_learn_step(at63, plain, xf, yf)
        mk, mp = sk.projs[0].mask, sp.projs[0].mask
        n_diff = int((mk != mp).sum().item())
        if n_diff == 0:
            worst = state_diff(sk, sp)
            print(f"[phase5] ({variant}) online fold across the rewire at "
                  f"clock 64: masks equal, kernel vs plain max abs diff "
                  f"{worst:.3e}", flush=True)
            check(worst <= 1e-4, f"({variant}) folds differ by {worst:.3e}")
            continue
        # Masks part only on near-ties: the swapped pre-HCs' MI, from the
        # plain path's learned traces, must lie within MI_TIE_TOL.
        p63, pplain = at63.projs[0], plain.projs[0]
        mi = dense_mi(learn(p63, pplain, xf, forward(p63, pplain, xf)),
                      pplain)
        gaps = []
        for j in torch.nonzero((mk != mp).any(dim=0)).flatten().tolist():
            only_k = torch.nonzero((mk[:, j] > 0) & (mp[:, j] == 0)).flatten()
            only_p = torch.nonzero((mp[:, j] > 0) & (mk[:, j] == 0)).flatten()
            gaps.append((mi[only_k, j].max() - mi[only_p, j].min()).abs()
                        .item())
        print(f"[phase5] ({variant}) online fold across the rewire: masks "
              f"differ in {n_diff // 2} pre-HC swaps, largest MI gap "
              f"{max(gaps):.3e} (tolerance {MI_TIE_TOL})", flush=True)
        check(max(gaps) <= MI_TIE_TOL, f"({variant}) rewires part on an MI "
                                       f"gap of {max(gaps):.3e}")


def struct_served_rates(torch, tr, xte):
    """(c)'s hidden rates on 2048 test rows, kernel and plain path, each
    against an fp64 forward of the densified weights."""
    from repro_torch.core.compact import densify_projection
    from repro_torch.core.network import stack_rates
    spec, state = tr.spec, tr.state
    x = torch.from_numpy(xte).cuda()
    pspec = spec.projs[0]
    dense = densify_projection(state.projs[0], pspec)
    s64 = dense.b.double() + x.double() @ dense.w.double()
    r64 = torch.softmax(s64.view(len(x), pspec.post.H, pspec.post.M) *
                        pspec.gain, dim=-1).view(len(x), -1)
    hk = stack_rates(state, spec, x)
    hp = stack_rates(state, spec.with_backend("torch"), x)
    err_k = (hk.double() - r64).abs().max().item()
    err_p = (hp.double() - r64).abs().max().item()
    print(f"[phase5] (c) hidden rates on {len(xte)} rows, max abs err vs "
          f"fp64: kernel {err_k:.3e}, plain {err_p:.3e}", flush=True)
    check(err_k <= max(1e-5, 2 * err_p),
          f"(c) kernel hidden rates {err_k:.3e} from fp64, plain "
          f"{err_p:.3e}")


def phase5(torch, xtr, ytr, xte, yte):
    fitted, launches = struct_fits(torch, xtr, ytr, xte, yte)
    moved = {}
    for variant in STRUCT_VARIANTS:
        no_sync_steps(torch, variant, xtr, ytr)
        moved[variant] = no_sync_replays(torch, variant, xtr, ytr)
    print("[phase5] (c), (b), (a): 70 steps across a rewire, a masked "
          "step, a readout step and an online fold each ran with no device "
          "synchronisation; so did 69 replayed unsupervised steps across "
          "the rewire at clock 64 (pre-HCs it moved: "
          + ", ".join(f"({v}) {m}" for v, m in moved.items())
          + "), two replayed readout steps and two eval batches",
          flush=True)
    struct_tail_fit(torch, xtr, ytr)
    struct_single_steps(torch, fitted, xtr, ytr)
    struct_served_rates(torch, fitted["c"], xte)
    return fitted, launches


# --------------------------------------------------------------- phase 6 --

# The repo's accuracy gate for low-precision serving
# (benchmarks/run.py:36, DESIGN.md §8): bf16 or int8 evaluation of a state
# may lose at most this much test accuracy against fp32, in points.
MAX_QUANT_ACC_DELTA_PP = 0.5
# The forward kernel each state's stack projection runs per serving dtype.
SERVE_KERNELS = {
    "model1": {"int8": "quant_fwd", "bf16": "bcpnn_fwd"},
    "struct_a": {"int8": "quant_patchy_forward", "bf16": "patchy_forward"},
    "struct_b": {"int8": "quant_patchy_forward", "bf16": "patchy_forward"},
    "struct_c": {"int8": "quant_compact_forward", "bf16": "compact_forward"},
}


def phase6_accuracy(torch, trainers, xte, yte, batch=128,
                    kernels=SERVE_KERNELS, tag="[phase6]"):
    """Each fitted state evaluated on the test rows in fp32, then in int8
    and bf16 with the launch counts set to 0 just before and read just
    after: accuracy within the gate, and exactly one forward-kernel and one
    hc_softmax launch per batch (the readout's product is a plain matmul,
    as in the reference)."""
    from repro_torch.core import evaluate_padded
    from repro_torch.kernels import ops
    batches = -(-len(xte) // batch)
    runs = {}
    for run, tr in trainers.items():
        acc32 = tr.evaluate(xte, yte, batch=batch)
        line = [f"fp32 {acc32:.4f}"]
        for dtype in ("int8", "bf16"):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            acc = evaluate_padded(tr.state, tr.spec.with_infer_dtype(dtype),
                                  xte, yte, batch)
            torch.cuda.synchronize()
            got = ops.launch_counts()
            want = {name: 0 for name in got}
            want[kernels[run][dtype]] = batches
            want["hc_softmax"] = batches
            check(got == want, f"({run}, {dtype}) evaluation launched {got}, "
                               f"predicted {want}")
            delta = (acc32 - acc) * 100
            check(delta <= MAX_QUANT_ACC_DELTA_PP,
                  f"({run}) {dtype} test accuracy {acc:.4f} loses "
                  f"{delta:.2f} pp against fp32 {acc32:.4f} (gate "
                  f"{MAX_QUANT_ACC_DELTA_PP} pp)")
            line.append(f"{dtype} {acc:.4f} ({(acc - acc32) * 100:+.2f} pp)")
            runs[f"{run}_{dtype}"] = got
        print(f"{tag} ({run}) test accuracy on {len(xte)} rows: "
              + ", ".join(line) + f"; launches as predicted ({batches} "
              f"batches)", flush=True)
    return runs


def phase6_serving(torch, run, tr, xte, yte):
    """int8 serving of one fitted state: a padded request bucket, the
    kernel path against the plain path on the test rows, and a repack
    after a feedback fold."""
    from repro_torch.core.bcpnn_layer import packed_forward, packed_support
    from repro_torch.core.network import (infer, infer_packed,
                                          online_learn_step, pack_state)
    dev = tr.device
    spec, state = tr.spec.with_infer_dtype("int8"), tr.state
    params = pack_state(state, spec)
    xb = torch.zeros((8, xte.shape[1]), dtype=torch.float32, device=dev)
    xb[:5] = torch.from_numpy(xte[:5]).to(dev)
    valid = (torch.arange(8, device=dev) < 5).to(torch.float32)
    probs, pred = infer_packed(params, spec, xb, valid)
    check(bool((probs[5:] == 0).all()), f"({run}) int8 pad rows carry "
                                        f"probability")
    check(bool((pred[5:] == -1).all()), f"({run}) int8 pad rows carry a "
                                        f"prediction")
    _, pred5 = infer_packed(params, spec, xb[:5])
    check(bool((pred[:5] == pred5).all()), f"({run}) padding changed an int8 "
                                           f"prediction")

    x = torch.from_numpy(xte).to(dev)
    pk, qk = infer(state, spec, x)
    pp, qp = infer(state, spec.with_backend("torch"), x)
    err = (pk - pp).abs().max().item()
    agree = (qk == qp).float().mean().item()
    check(err <= 1e-4, f"({run}) int8 served probs differ by {err:.3e} > 1e-4")
    check(agree >= 0.999, f"({run}) int8 served preds agree on only "
                          f"{agree:.6f}")

    # Stale-scale rule: after a fold, packing again gives new scales and
    # serving reads them.  The fitted readout's probabilities saturate, so
    # the packs are told apart by the hidden rates and the readout support.
    xf = torch.from_numpy(xte[:128]).to(dev)
    yf = torch.from_numpy(yte[:128]).to(dev)
    folded = online_learn_step(state, spec, xf, yf)
    fresh = pack_state(folded, spec)
    moved = [bool((a.scale != b.scale).any())
             for a, b in zip(fresh.projs + (fresh.readout,),
                             params.projs + (params.readout,))]
    check(all(moved), f"({run}) repacking after a fold left a projection's "
                      f"scales as they were: {moved}")
    p_fresh, _ = infer_packed(fresh, spec, x)
    check(torch.equal(p_fresh, infer(folded, spec, x)[0]),
          f"({run}) the repacked serving path disagrees with infer on the "
          f"folded state")
    ps, rs = spec.projs[0], spec.readout
    h_fresh = packed_forward(fresh.projs[0], ps, xf)
    h_stale = packed_forward(params.projs[0], ps, xf)
    d_hidden = (h_fresh - h_stale).abs().max().item()
    d_support = (packed_support(fresh.readout, rs, h_fresh)
                 - packed_support(params.readout, rs, h_fresh)
                 ).abs().max().item()
    check(d_hidden > 0 and d_support > 0,
          f"({run}) the stale pack serves what the fresh one does (hidden "
          f"rates {d_hidden:.3e}, readout support {d_support:.3e} apart)")
    print(f"[phase6] ({run}) int8 serving: bucket of 8 (5 valid) pad rows "
          f"inert; kernel vs plain infer on {len(xte)} rows max abs err "
          f"{err:.3e}, pred agreement {agree:.6f}; after a fold every "
          f"projection's scales moved and serving read them (stale pack's "
          f"hidden rates {d_hidden:.3e} and readout support {d_support:.3e} "
          f"away)", flush=True)


def phase6_no_sync(torch, trainers, xte):
    """Packing and serving in int8 with any implicit device
    synchronisation an error."""
    from repro_torch.core.network import infer_packed, pack_state
    x = torch.from_numpy(xte[:128]).cuda()
    for run in ("model1", "struct_c"):
        spec = trainers[run].spec.with_infer_dtype("int8")
        state = trainers[run].state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params = pack_state(state, spec)
            for _ in range(3):
                infer_packed(params, spec, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print("[phase6] int8 pack_state and infer_packed of Model 1 and (c) ran "
          "with no device synchronisation", flush=True)


def phase6(torch, tr, fitted, xte, yte):
    trainers = {"model1": tr, **{f"struct_{v}": t for v, t in fitted.items()}}
    runs = phase6_accuracy(torch, trainers, xte, yte)
    for run in trainers:
        phase6_serving(torch, run, trainers[run], xte, yte)
    phase6_no_sync(torch, trainers, xte)
    return runs


# --------------------------------------------------------------- phase 8 --

# 64-batch chunks of the fit before the kill: the fifth ends at batch 64 of
# the third unsupervised epoch.
KILL_CHUNK = 5
# The Poisson rate of the served streams (requests/s): a bucket-64 batch
# takes far less than the 16 ms such a rate needs to fill it.
SERVE_RATE_HZ = 4000.0
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def phase8(torch, tr, fitted, data):
    """Checkpoints, then serving through ``BCPNNService`` at full width;
    returns (launches per served stream, phase-4 rows of the served
    batches)."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="phase8_", dir=ROOT / "build"))
    try:
        phase8_checkpoints(torch, tr, data, root)
        runs, rows = phase8_serving(torch, tr, fitted, data)
        runs.update(phase8_online(torch, tr, fitted, data))
        phase8_quarantine(torch, tr, data)
        phase8_launcher(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs, rows


def kill_and_resume(torch, label, cfg, xtr, ytr, root):
    """A fit checkpointing every 64 batches, killed by ``on_chunk``
    raising ``WorkerLost`` after chunk ``KILL_CHUNK``, resumed by a trainer
    of another seed, against the uninterrupted fit: every tensor, mask,
    table, clock and the generator's state equal."""
    from repro_torch.core import Trainer
    from repro_torch.distributed import WorkerLost
    ref = Trainer(cfg, seed=0, device="cuda")
    ref.fit(xtr, ytr, epochs=5, batch=128, ckpt_every_batches=64)
    d = str(root / label.strip("()").replace(" ", "_"))
    seen = []

    def boom(cur):
        seen.append(cur)
        if len(seen) == KILL_CHUNK:
            raise WorkerLost(f"killed at {cur}")

    killed = Trainer(cfg, seed=0, device="cuda")
    try:
        killed.fit(xtr, ytr, epochs=5, batch=128, ckpt_dir=d,
                   ckpt_every_batches=64, on_chunk=boom)
        fail(f"{label}: the fit ran past the kill")
    except WorkerLost:
        pass
    check(seen[-1].phase == "unsupervised" and seen[-1].batch == 64,
          f"{label}: the kill came at {seen[-1]}, not mid unsupervised "
          f"epoch")
    del killed
    t = time.perf_counter()
    resumed = Trainer(cfg, seed=1, device="cuda")
    stats = resumed.fit(xtr, ytr, epochs=5, batch=128, ckpt_dir=d,
                        ckpt_every_batches=64, resume=True)
    t_resume = time.perf_counter() - t
    worst, n, same = state_identity(torch, ref.state, resumed.state)
    gen_same = torch.equal(ref.state.generator.get_state(),
                           resumed.state.generator.get_state())
    print(f"[phase8] {label} fit killed after chunk {KILL_CHUNK} at "
          f"{seen[-1]}, resumed ({t_resume:.3f} s, straggler_events "
          f"{stats['straggler_events']:.0f}): state max abs diff "
          f"{worst:.3e} over {n} arrays vs the uninterrupted fit, masks, "
          f"tables and clocks {'equal' if same else 'DIFFER'}, generator "
          f"{'equal' if gen_same else 'DIFFERS'}", flush=True)
    check(worst == 0 and same and gen_same,
          f"{label}: the resumed fit parts from the uninterrupted one")
    return ref


def phase8_checkpoints(torch, tr, data, root):
    from repro_torch.checkpoint import load_model
    from repro_torch.core import evaluate_padded
    xtr, ytr, xte, yte = data
    d = str(root / "model1")
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.save(d)
    save_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    state, spec, step = load_model(d)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    worst, n, same = state_identity(torch, tr.state, state)
    gen_same = torch.equal(tr.state.generator.get_state(),
                           state.generator.get_state())
    acc, acc_tr = evaluate_padded(state, spec, xte, yte), tr.evaluate(xte, yte)
    nbytes = sum(os.path.getsize(os.path.join(d, f"step_{step}", f))
                 for f in os.listdir(os.path.join(d, f"step_{step}")))
    print(f"[phase8] Model 1 Trainer.save (blocking) {save_ms:.1f} ms, "
          f"load_model {restore_ms:.1f} ms, {nbytes / 1e6:.1f} MB at step "
          f"{step}; restored state max abs diff {worst:.3e} over {n} "
          f"arrays, masks and clocks {'equal' if same else 'DIFFER'}, "
          f"generator {'equal' if gen_same else 'DIFFERS'}; test accuracy "
          f"{acc:.6f} (trainer {acc_tr:.6f})", flush=True)
    check(spec == tr.spec, f"load_model gave spec {spec}")
    check(worst == 0 and same and gen_same,
          "load_model's state parts from the saved trainer's")
    check(acc == acc_tr, f"the loaded state evaluates {acc}, the trainer "
                         f"{acc_tr}")
    from repro_torch.configs.bcpnn_models import MODEL1_MNIST
    kill_and_resume(torch, "Model 1", MODEL1_MNIST, xtr, ytr, root)
    # (c) rewires every 64 steps of its clock: at 384, 448, ... after the
    # kill at clock 320
    kill_and_resume(torch, "(c)", struct_cfg("c"), xtr, ytr, root)


class Recorder:
    """Wraps a slot's ``ServeProgram.serve``: every served batch's padded
    input and results, in order."""

    def __init__(self, program):
        self.serve, self.records, self.walls = program.serve, [], []
        program.serve = self

    def __call__(self, x, valid):
        t = time.perf_counter()
        probs, pred = self.serve(x, valid)
        self.walls.append(time.perf_counter() - t)
        self.records.append((x.copy(), valid.copy(), probs, pred))
        return probs, pred

    def replay_launches(self, buckets, start=0, stop=None) -> dict:
        """The launches the recorded batches' replays added (those of
        ``records[start:stop]``)."""
        out: dict = {}
        for x, *_ in self.records[start:stop]:
            for k, c in buckets[len(x)].launches.items():
                out[k] = out.get(k, 0) + c
        return out

    def wall_us(self) -> str:
        """p50/p99 of the served batches' ``serve`` walls, in µs."""
        w = np.asarray(self.walls) * 1e6
        return (f"{np.percentile(w, 50):.1f}/{np.percentile(w, 99):.1f} "
                f"us")

    def check_eager(self, torch, label, pack, spec, start=0):
        """Each recorded batch from ``start`` against eager
        ``infer_packed`` on the same padded group, bit for bit."""
        from repro_torch.core.network import infer_packed
        for x, valid, probs, pred in self.records[start:]:
            p, q = infer_packed(pack, spec, torch.from_numpy(x).cuda(),
                                torch.from_numpy(valid).cuda())
            check(np.array_equal(p.cpu().numpy(), probs)
                  and np.array_equal(q.cpu().numpy(), pred),
                  f"{label}: a served bucket of {len(x)} parts from eager "
                  f"infer_packed")
        return len(self.records) - start


# run -> (p50 ms, p99 ms, images/s) of phase 8's single-engine streams, from
# the served rows' latencies and the stream's wall, for phase 9 to print
# beside the router's.
SINGLE_ENGINE = {}


def stream_figures(rep):
    """(p50 ms, p99 ms, images/s) of an open-loop report's served rows."""
    lat = np.asarray([r.latency_ms for r in rep.results])
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)),
            len(rep.results) / rep.wall_s)


def serve_stream(torch, label, state, spec, dtype, kernels, xte, yte):
    """All test rows, each once, through a started service at
    ``SERVE_RATE_HZ``; the launch counts set to 0 just before and read
    just after, and each of ``kernels`` launched."""
    from repro_torch.core import evaluate_padded
    from repro_torch.kernels import ops
    from repro_torch.serve import BCPNNService, run_open_loop
    svc = BCPNNService(state, spec, max_batch=64, infer_dtype=dtype)
    slot = svc._slot(None)
    rec = Recorder(slot.program)
    t = time.perf_counter()
    svc.start()
    warm_s = time.perf_counter() - t
    check(tuple(sorted(slot.program.buckets)) == SERVE_BUCKETS,
          f"{label}: captured buckets {sorted(slot.program.buckets)}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = run_open_loop(svc, xte, yte, n_requests=len(xte),
                        rate_hz=SERVE_RATE_HZ, seed=0, replace=False)
    svc.stop()
    launches = ops.launch_counts()
    snap = svc.snapshot()
    n = rec.check_eager(torch, label, slot.pack, slot.spec)
    want = {k: 0 for k in launches}
    want.update(rec.replay_launches(slot.program.buckets))
    check(launches == want, f"{label}: the stream launched {launches}, its "
                            f"replays' captures count {want}")
    check(all(launches[k] > 0 for k in kernels),
          f"{label}: the stream launched {launches}, none of one of "
          f"{kernels}")
    check(len(rep.results) == len(xte) and not rep.errors
          and not rep.n_rejected, f"{label}: {len(rep.results)} served, "
                                  f"{len(rep.errors)} failed")
    acc = rep.accuracy()
    acc6 = evaluate_padded(state, slot.spec, xte, yte)
    per_bucket = {b: sum(p.launches.values())
                  for b, p in sorted(slot.program.buckets.items())}
    hist = {}
    for x, *_ in rec.records:
        hist[len(x)] = hist.get(len(x), 0) + 1
    print(f"[phase8] serve {label}: {len(rep.results)} rows at "
          f"{SERVE_RATE_HZ:.0f}/s offered in {n} batches {hist}, p50 "
          f"{snap['p50_ms']:.3f} ms p99 {snap['p99_ms']:.3f} ms, "
          f"{snap['images_per_s']:.1f} images/s, occupancy "
          f"{snap['batch_occupancy']:.3f}, ServeProgram.serve p50/p99 "
          f"{rec.wall_us()}, timed batch median "
          f"{svc.step_timer.median * 1e6:.1f} us; every row equals eager "
          f"infer_packed; accuracy {acc:.6f} (phase 6's evaluation "
          f"{acc6:.6f}); warm-up {warm_s:.3f} s; launches per captured "
          f"bucket {per_bucket}; stream launches {json.dumps(launches)}",
          flush=True)
    check(acc == acc6, f"{label}: served accuracy {acc} != {acc6}")
    SINGLE_ENGINE[label] = stream_figures(rep)
    return launches, slot


def phase8_serving(torch, tr, fitted, data):
    from repro_torch.core.network import infer_packed
    xtr, ytr, xte, yte = data
    runs, rows = {}, {}
    x64 = torch.from_numpy(xte[:64]).cuda()
    v64 = torch.ones(64, device="cuda")
    x64h, v64h = xte[:64].copy(), np.ones(64, np.float32)
    for run, t, dtype, fwd in (
            ("model1_fp32", tr, "fp32", "bcpnn_fwd"),
            ("model1_int8", tr, "int8", "quant_fwd"),
            ("struct_c_int8", fitted["c"], "int8", "quant_compact_forward")):
        launches, slot = serve_stream(torch, run, t.state, t.spec, dtype,
                                      (fwd, "hc_softmax"), xte, yte)
        runs[f"serve_{run}"] = launches
        prog, pack, sp = slot.program, slot.pack, slot.spec
        rows[f"{run} served_batch[64] eager"] = \
            lambda pack=pack, sp=sp: infer_packed(pack, sp, x64, v64)
        rows[f"{run} served_batch[64] graphed"] = \
            lambda prog=prog: prog(x64, v64)
        rows[f"{run} served_batch[64] graphed, one wait"] = \
            lambda prog=prog: (prog(x64, v64),
                               torch.cuda.current_stream().synchronize())
        rows[f"{run} served_batch[64] graphed, host in and out"] = \
            lambda prog=prog: prog.serve(x64h, v64h)
    return runs, rows


def feedback_recorder(svc):
    """Wraps ``svc.feedback``: the labelled rows in the order admitted."""
    fed, feedback = [], svc.feedback

    def record(x, label, model=None):
        feedback(x, label, model=model)
        fed.append((np.asarray(x, np.float32), int(label)))

    svc.feedback = record
    return fed


def replay(state, fed, batch, step):
    """The offline replay of a feedback stream: full batches, then one
    cycled tail, through ``step``."""
    from repro_torch.serve import cycle_batch
    import torch
    while fed:
        chunk, fed = fed[:batch], fed[batch:]
        x, y = (torch.from_numpy(a).cuda() for a in cycle_batch(chunk, batch))
        state = step(state, x, y)
    return state


def wait_for(cond, what, timeout_s=120.0):
    end = time.perf_counter() + timeout_s
    while not cond():
        check(time.perf_counter() < end, f"timed out waiting for {what}")
        time.sleep(0.002)


def phase8_online(torch, tr, fitted, data):
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.core import evaluate_padded, init_projection
    from repro_torch.core.network import (online_learn_step, pack_state,
                                          supervised_readout_step)
    from repro_torch.device import make_generator
    from repro_torch.serve import BCPNNService, run_open_loop
    xtr, ytr, xte, yte = data
    spec, state = tr.spec, tr.state
    cold = dataclasses.replace(state, readout=init_projection(
        spec.readout, make_generator(99, state.device)))
    acc_base = evaluate_padded(state, spec, xte, yte)
    acc_cold = evaluate_padded(cold, spec, xte, yte)
    svc = BCPNNService(cold, spec, max_batch=64, online_learning=True,
                       feedback_batch=64, feedback_eager=False)
    fed = feedback_recorder(svc)
    rec = Recorder(svc._slot(None).program)
    svc.start()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = run_open_loop(svc, xte, yte, n_requests=len(xte),
                        rate_hz=SERVE_RATE_HZ, seed=1, feedback_frac=1.0,
                        fb_x=xtr, fb_y=ytr)
    svc.stop()
    runs = {"online_model1_readout": ops.launch_counts()}
    snap = svc.snapshot()
    per_fold = fold_launches(runs["online_model1_readout"], rec,
                             svc._slot(None).program, snap["learn_steps"])
    acc = evaluate_padded(svc.state, spec, xte, yte)
    floor = acc_cold + 0.3 * max(0.0, acc_base - acc_cold)
    ref = replay(cold, list(fed), 64, lambda st, x, y:
                 supervised_readout_step(st, spec, x, y))
    worst, n, same = state_identity(torch, ref, svc.state)
    print(f"[phase8] Model 1 cold readout relearned from {len(fed)} "
          f"feedback rows in {snap['learn_steps']:.0f} folds while serving "
          f"{len(rep.results)} requests (p50 {snap['p50_ms']:.3f} ms, p99 "
          f"{snap['p99_ms']:.3f} ms): test accuracy cold {acc_cold:.4f} -> "
          f"{acc:.4f} (floor {floor:.4f}, trained {acc_base:.4f}), served "
          f"{rep.accuracy(0, 0.3):.4f} early -> {rep.accuracy(0.7, 1):.4f} "
          f"late; offline replay max abs diff {worst:.3e}; launches per "
          f"fold {per_fold}", flush=True)
    check(acc > floor, f"online relearning reached {acc} <= floor {floor}")
    check(worst == 0 and same, "the served folds part from the offline "
                               "replay of the same feedback")
    check(len(rep.results) == len(xte), "online serving dropped requests")

    trb = fitted["b"]
    spec_b, state_b = trb.spec, trb.state
    svc = BCPNNService(state_b, spec_b, max_batch=64, online_learning=True,
                       learn_stack=True, feedback_batch=32,
                       feedback_eager=False)
    fed = feedback_recorder(svc)
    rec = Recorder(svc._slot(None).program)
    svc.start()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = run_open_loop(svc, xte, yte, n_requests=len(xte),
                        rate_hz=SERVE_RATE_HZ, seed=2, feedback_frac=1.0,
                        fb_x=xtr, fb_y=ytr)
    for i in range(8 * 32):  # past the next struct_every boundary
        svc.feedback(xtr[i], int(ytr[i]))
    folds = len(fed) // 32
    wait_for(lambda: svc.snapshot()["learn_steps"] == folds, "the folds")
    start = len(rec.records)
    ids = [svc.submit(x) for x in xte[:200]]
    for rid in ids:
        svc.result(rid, timeout=60)
    svc.stop()
    runs["online_struct_b_stack"] = ops.launch_counts()
    per_fold_b = fold_launches(runs["online_struct_b_stack"], rec,
                               svc._slot(None).program, folds)
    final = svc.state
    n_after = rec.check_eager(torch, "(b) after the rewire",
                              pack_state(final, spec_b), spec_b, start)
    ref = replay(state_b, list(fed), 32, lambda st, x, y: online_learn_step(
        st, spec_b, x, y, learn_stack=True))
    worst, n, same = state_identity(torch, ref, final)
    t0, t1 = state_b.projs[0].traces.t_host, final.projs[0].traces.t_host
    moved = int((final.projs[0].mask != state_b.projs[0].mask).sum()) // 2
    svc.revalidate()
    print(f"[phase8] (b) learn_stack: {len(fed)} feedback rows in "
          f"{folds} folds, clock {t0} -> {t1} across "
          f"{t1 // 64 - t0 // 64} rewire(s), {moved} pre-HCs moved; offline "
          f"replay max abs diff {worst:.3e}, masks and clocks "
          f"{'equal' if same else 'DIFFER'}; {n_after} batches served "
          f"after the rewire equal eager infer_packed; launches per fold "
          f"{per_fold_b}", flush=True)
    check(t1 // 64 > t0 // 64 and moved > 0, "(b): no rewire while serving")
    check(worst == 0 and same, "(b): the served stack folds part from the "
                               "offline replay")
    return runs


def fold_launches(launches, rec, program, folds) -> dict:
    """Launches per fold of an online stream: the stream's, less its
    served batches' replays, over the folds."""
    replays = rec.replay_launches(program.buckets)
    return {k: (n - replays.get(k, 0)) / folds
            for k, n in launches.items() if n - replays.get(k, 0)}


def phase8_quarantine(torch, tr, data):
    from repro_torch.core.graphs import state_tensors
    from repro_torch.core.network import infer_packed
    from repro_torch.serve import BCPNNService, FaultInjector, Quarantined
    xtr, ytr, xte, yte = data
    for label, schedule, nan_row in (("nan-state fault", {"nan-state": {1}},
                                      False),
                                     ("NaN feedback row", {}, True)):
        svc = BCPNNService(tr.state, tr.spec, max_batch=64,
                           online_learning=True, feedback_batch=64,
                           feedback_eager=False,
                           fault_injector=FaultInjector(schedule=schedule))
        svc.start()
        try:
            for i in range(64):
                svc.feedback(xtr[i], int(ytr[i]))
            wait_for(lambda: svc.snapshot()["learn_steps"] == 1, "a fold")
            good = [t.clone() for t in state_tensors(svc.model_state())]
            for i in range(64, 128):
                row = xtr[i].copy()
                if nan_row and i == 100:
                    row[5] = np.nan
                svc.feedback(row, int(ytr[i]))
            wait_for(lambda: svc.snapshot()["quarantined"] == 1.0,
                     f"the quarantine ({label})")
            rolled = all(torch.equal(g, a) for g, a in
                         zip(good, state_tensors(svc.model_state())))
            r = svc.classify(xte[0], timeout=60)
            p, q = infer_packed(svc.model_pack(), svc.spec,
                                torch.from_numpy(xte[:1]).cuda(),
                                torch.ones(1, device="cuda"))
            served = (r.pred == int(q[0]) and
                      np.array_equal(r.probs, p[0].cpu().numpy()))
            try:
                svc.feedback(xtr[0], int(ytr[0]))
                refused = False
            except Quarantined:
                refused = True
        finally:
            svc.stop()
        print(f"[phase8] quarantine ({label}): rolled back "
              f"{'bit for bit' if rolled else 'WRONGLY'}, still serving "
              f"{'as eager infer_packed' if served else 'WRONGLY'}, "
              f"feedback {'refused' if refused else 'ACCEPTED'}", flush=True)
        check(rolled and served and refused, f"quarantine ({label}) failed")


def phase8_launcher(root):
    """``python -m repro_torch.launch.serve_bcpnn --smoke`` in a process
    of its own."""
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_bcpnn", "--smoke",
         "--ckpt-dir", str(root / "launcher")], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    lines = (out.stdout + out.stderr).strip().splitlines()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "serve_bcpnn_smoke.log").write_text(
        out.stdout + out.stderr)
    for line in lines:
        if line.startswith("[serve-bcpnn]"):
            print(f"[phase8] {line}", flush=True)
    print(f"[phase8] serve_bcpnn --smoke: rc {out.returncode} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    check(out.returncode == 0, f"serve_bcpnn --smoke failed: "
                               f"{lines[-1:] or ['(no output)']}")


# --------------------------------------------------------------- phase 9 --

# The admitted-request index (in the Model-1 stream) at which the engine
# hosting both models is killed: drawn from this seed, in the middle half.
KILL_SEED = 21


class Front:
    """The serving front the open-loop generator drives in phase 9: the
    router, plus a kill of ``victim`` when the ``kill_at``-th request is
    admitted (a count, not a timer).  Records each submit's wall, the
    engine each router id went to, each id's one resolution, and the
    feedback rows in the order the router took them."""

    def __init__(self, router, victim=None, kill_at=None):
        self.router, self.victim, self.kill_at = router, victim, kill_at
        self.walls, self.engine, self.outcome, self.fed = [], {}, {}, []
        self.kill_t = None

    def submit(self, x, model=None, deadline_s=None):
        t = time.perf_counter()
        try:
            rid = self.router.submit(x, model=model, deadline_s=deadline_s)
        finally:
            self.walls.append((t, time.perf_counter() - t))
        with self.router._requests_lock:
            self.engine[rid] = self.router._requests[rid][0]
        if len(self.engine) == self.kill_at:
            self.router._engines[self.victim].kill("phase 9: engine loss")
            self.kill_t = time.perf_counter()
        return rid

    def result(self, request_id, timeout=None):
        check(request_id not in self.outcome,
              f"router id {request_id} resolved twice")
        try:
            res = self.router.result(request_id, timeout=timeout)
        except BaseException as e:
            self.outcome[request_id] = e
            raise
        self.outcome[request_id] = res
        return res

    def feedback(self, x, label, model=None):
        self.router.feedback(x, label, model=model)
        self.fed.append((np.asarray(x, np.float32), int(label)))


class Placements:
    """Wraps every engine of a router: the wall of each placement
    (``add_model``) and of its captures (``_warm_slot``, which also hangs
    a ``Recorder`` on the slot's served batches before it is published)."""

    def __init__(self, router):
        self.walls, self.recorders = {}, {}
        for eid, handle in router._engines.items():
            svc = handle.service
            add, warm = handle.add_model, svc._warm_slot

            def timed_add(model, *a, eid=eid, add=add, svc=svc, **k):
                t = time.perf_counter()
                add(model, *a, **k)
                self.walls.setdefault((eid, model), {}).update(
                    add_s=time.perf_counter() - t,
                    live=k.get("live", False))

            def timed_warm(slot, eid=eid, warm=warm):
                self.recorders[(eid, slot.name)] = Recorder(slot.program)
                t = time.perf_counter()
                warm(slot)
                self.walls.setdefault((eid, slot.name), {}).update(
                    capture_s=time.perf_counter() - t, t0=t,
                    t1=time.perf_counter())

            handle.add_model, svc._warm_slot = timed_add, timed_warm


def phase9(torch, tr, fitted, data):
    """The router at full width; returns the launches of its streams."""
    runs = phase9_failover(torch, tr, fitted, data)
    runs.update(phase9_online(torch, tr, data))
    return runs


def phase9_failover(torch, tr, fitted, data):
    """Model 1 fp32 and (c) int8 at replicas=2 on three engines; the engine
    hosting both killed at a seeded admitted-request index of the Model-1
    stream; both models re-placed by live captures while the stream runs;
    then the (c) stream on the recovered placement."""
    from repro_torch.kernels import ops
    from repro_torch.serve import BCPNNRouter, WorkerDied, run_open_loop
    xtr, ytr, xte, yte = data
    spec_c = fitted["c"].spec.with_infer_dtype("int8")
    models = (("model1_fp32", tr.state, tr.spec, ("bcpnn_fwd",
                                                   "hc_softmax")),
              ("struct_c_int8", fitted["c"].state, spec_c,
               ("quant_compact_forward", "hc_softmax")))
    router = BCPNNRouter.local(3, max_batch=64)
    placed = Placements(router)
    for name, state, spec, _ in models:
        router.add_model(name, state, spec, replicas=2)
    t = time.perf_counter()
    router.start()
    start_s = time.perf_counter() - t
    hosts = {name: router.placement(name)["replicas"] for name, *_ in models}
    check(hosts == {"model1_fp32": ("engine0", "engine1"),
                    "struct_c_int8": ("engine2", "engine0")},
          f"placements {hosts}")
    victim = "engine0"
    kill_at = int(np.random.default_rng(KILL_SEED).integers(
        len(xte) // 4, 3 * len(xte) // 4))
    router.start_maintenance(period_s=0.005)  # the router's own probe
    runs, figures = {}, {}
    for (name, state, spec, kernels), seed in zip(models, (0, 1)):
        front = Front(router, victim, kill_at if seed == 0 else None)
        marks = {k: len(r.records) for k, r in placed.recorders.items()}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rep = run_open_loop(front, xte, yte, n_requests=len(xte),
                            rate_hz=SERVE_RATE_HZ, seed=seed, replace=False,
                            model=name)
        launches = ops.launch_counts()
        runs[f"router_{name}"] = launches
        want = {k: 0 for k in launches}
        for key, r in placed.recorders.items():
            for k, c in r.replay_launches(
                    router._engines[key[0]].service._slot(
                        key[1]).program.buckets,
                    marks.get(key, 0)).items():
                want[k] += c
        check(launches == want, f"router {name}: the stream launched "
                                f"{launches}, its replays' captures {want}")
        check(all(launches[k] > 0 for k in kernels),
              f"router {name}: none of one of {kernels} launched")
        check(len(rep.results) + len(rep.errors) + rep.n_rejected
              == len(xte), f"router {name}: accounting does not close")
        check(set(front.outcome) == set(front.engine),
              f"router {name}: {len(front.engine)} ids admitted, "
              f"{len(front.outcome)} resolved")
        bad = [(rid, type(e).__name__, front.engine[rid])
               for rid, e in front.outcome.items()
               if isinstance(e, BaseException)
               and not (isinstance(e, WorkerDied)
                        and front.engine[rid] == victim)]
        check(not bad, f"router {name}: failures other than WorkerDied on "
                       f"{victim}: {bad[:5]}")
        check(rep.n_rejected == 0, f"router {name}: {rep.n_rejected} "
                                   f"rejected")
        acc = rep.accuracy()
        figures[name] = (rep, front, acc)
    snap = router.metrics.snapshot()
    place = {name: router.placement(name)["replicas"] for name, *_ in models}
    errs = router.stop()
    check(victim in errs and snap["engine_losses"] == 1
          and snap["replacements"] == 2,
          f"router: the loss was not handled once ({snap}, {errs})")
    check(place == {"model1_fp32": ("engine1", "engine2"),
                    "struct_c_int8": ("engine2", "engine1")},
          f"router: placements after the loss {place}")
    rep1, front1, _ = figures["model1_fp32"]
    lives = {k: v for k, v in placed.walls.items() if v["live"]}
    check(set(lives) == {("engine2", "model1_fp32"),
                         ("engine1", "struct_c_int8")},
          f"router: live placements {sorted(lives)}")
    after = [t for t, _ in front1.walls if t > max(
        v["t1"] for v in lives.values())]
    check(front1.kill_t is not None and all(
        front1.kill_t < v["t0"] for v in lives.values()) and after,
          "router: the re-placements were not captured while the Model-1 "
          "stream ran")
    for key, v in lives.items():
        prog = router._engines[key[0]].service._slot(key[1]).program
        check(tuple(sorted(prog.buckets)) == SERVE_BUCKETS,
              f"router {key}: live capture of buckets {sorted(prog.buckets)}")
    n_checked = 0
    for (eid, model), r in sorted(placed.recorders.items()):
        slot = router._engines[eid].service._slot(model)
        n_checked += r.check_eager(torch, f"router {eid}/{model}", slot.pack,
                                   slot.spec)
    for (eid, model) in lives:
        check(len(placed.recorders[(eid, model)].records) > 0,
              f"router: the re-placed {model} on {eid} served nothing")
    died = sum(isinstance(o, WorkerDied) for o in front1.outcome.values())
    blocked = sorted(w for _, w in front1.walls)
    for name, (rep, front, acc) in figures.items():
        p50, p99, ips = stream_figures(rep)
        s50, s99, sips = SINGLE_ENGINE[name]
        print(f"[phase9] router {name}: {len(rep.results)} served / "
              f"{len(rep.errors)} WorkerDied / {rep.n_rejected} rejected "
              f"of {len(xte)} at {SERVE_RATE_HZ:.0f}/s offered: p50 "
              f"{p50:.3f} ms p99 {p99:.3f} ms, {ips:.1f} images/s, served "
              f"accuracy {acc:.6f} (phase 8's single engine: p50 "
              f"{s50:.3f} ms p99 {s99:.3f} ms, {sips:.1f} images/s); "
              f"launches {json.dumps(runs[f'router_{name}'])}", flush=True)
    print(f"[phase9] router failover: 3 engines, Model 1 fp32 and (c) int8 "
          f"at replicas=2 (start {start_s:.3f} s); {victim} killed at "
          f"admitted request {kill_at} of the Model-1 stream; {died} "
          f"in-flight ids on it resolved WorkerDied, every id exactly "
          f"once; recovery (loss to last re-placement) "
          f"{snap.get('recovery_s_max', 0.0) * 1e3:.1f} ms; live "
          f"re-placements " + ", ".join(
              f"{m} -> {e} {v['add_s'] * 1e3:.1f} ms (captures "
              f"{v['capture_s'] * 1e3:.1f} ms)"
              for (e, m), v in sorted(lives.items())) +
          f"; submits blocked: longest {blocked[-1] * 1e3:.1f} ms, "
          f"{sum(w > 1e-3 for w in blocked)} over 1 ms; {n_checked} served "
          f"batches on 3 engines equal eager infer_packed bit for bit",
          flush=True)
    return runs


def phase9_online(torch, tr, data):
    """A cold Model-1 readout learning online on 2 replicas through the
    router, reconciled and held to the offline replay; then a NaN fold on
    one replica, drained, revalidated and repaired by ``heal``."""
    import dataclasses
    from repro_torch.core import init_projection
    from repro_torch.core.graphs import state_tensors
    from repro_torch.core.network import supervised_readout_step
    from repro_torch.device import make_generator
    from repro_torch.kernels import ops
    from repro_torch.serve import (BCPNNRouter, FaultInjector,
                                   merge_replica_states, run_open_loop,
                                   states_bitwise_equal)
    xtr, ytr, xte, yte = data
    spec, state = tr.spec, tr.state
    cold = dataclasses.replace(state, readout=init_projection(
        spec.readout, make_generator(99, state.device)))
    # every request carries a feedback row: the stream makes len(xte) / 64
    # folds, and engine0's next fold is corrupted (a NaN)
    heal_fold = len(xte) // 64
    inj = FaultInjector(seed=KILL_SEED, schedule={"nan-state": {heal_fold}})
    router = BCPNNRouter.local(2, max_batch=64, online_learning=True,
                               feedback_batch=64, feedback_eager=False,
                               fault_injectors=[inj, None])
    router.add_model("readout", cold, spec, replicas=2, online=True)
    router.start()
    engines = [router._engines[e] for e in ("engine0", "engine1")]
    front = Front(router)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rep = run_open_loop(front, xte, yte, n_requests=len(xte),
                            rate_hz=SERVE_RATE_HZ, seed=3, feedback_frac=1.0,
                            fb_x=xtr, fb_y=ytr, replace=False,
                            model="readout")
        folds = len(front.fed) // 64
        check(folds == heal_fold, f"{len(front.fed)} feedback rows")
        wait_for(lambda: all(h.snapshot(model="readout")["learn_steps"]
                             == folds for h in engines), "the folds")
        launches = ops.launch_counts()
        t = time.perf_counter()
        rec = router.reconcile("readout")["readout"]
        reconcile_ms = (time.perf_counter() - t) * 1e3
        states = [h.model_state_sync("readout") for h in engines]
        ref = replay(cold, list(front.fed), 64, lambda st, x, y:
                     supervised_readout_step(st, spec, x, y))
        worst, n, same = state_identity(torch, ref, states[0])
        merged_ok = states_bitwise_equal(merge_replica_states(states),
                                         states[1])
        n_fed = len(front.fed)
        # (iii): the next fold of engine0 is corrupted
        for i in range(64):
            front.feedback(xtr[i], int(ytr[i]), model="readout")
        wait_for(lambda: engines[0].quarantined("readout")
                 and engines[1].snapshot(model="readout")["learn_steps"]
                 == folds + 1, "the quarantine")
        t = time.perf_counter()
        healed = router.heal()
        heal_ms = (time.perf_counter() - t) * 1e3
        a, b = (h.model_state_sync("readout") for h in engines)
        own = not ({x.data_ptr() for x in state_tensors(a)}
                   & {x.data_ptr() for x in state_tensors(b)})
        rec2 = router.reconcile("readout")["readout"]
        served = [router.classify(x, timeout=60) for x in xte[:8]]
        snap = router.metrics.snapshot()
    finally:
        router.stop()
    print(f"[phase9] online readout on 2 replicas: {n_fed} "
          f"feedback rows broadcast in {folds} folds each while serving "
          f"{len(rep.results)} requests; reconcile {reconcile_ms:.1f} ms: "
          f"{'consistent' if rec.get('consistent') else rec}; replicas "
          f"{'equal' if states_bitwise_equal(*states) else 'DIFFER'} bit "
          f"for bit, merge {'equal' if merged_ok else 'DIFFERS'}; offline "
          f"replay max abs diff {worst:.3e} over {n} tensors; launches "
          f"{json.dumps(launches)}", flush=True)
    check(rec.get("consistent") is True and states_bitwise_equal(*states)
          and merged_ok, f"online replicas not reconciled: {rec}")
    check(worst == 0 and same, "the replicas part from the offline replay")
    check(len(rep.results) == len(xte) and not rep.errors,
          "online router stream dropped requests")
    print(f"[phase9] heal: a nan-state fault at engine0's fold "
          f"{heal_fold + 1} quarantined it; heal {heal_ms:.1f} ms drained, "
          f"revalidated and repaired it from engine1: "
          f"{'bit for bit' if states_bitwise_equal(a, b) else 'WRONGLY'}, "
          f"{'own tensors' if own else 'SHARED tensors'}; then reconcile "
          f"{'consistent' if rec2.get('consistent') else rec2}, "
          f"{len(served)} rows served", flush=True)
    check(healed == {"readout": ["engine0"]} and states_bitwise_equal(a, b)
          and own and rec2.get("consistent") is True
          and snap["quarantine_drains"] == 1,
          f"heal failed: {healed}, {rec2}, {snap}")
    return {"router_online_readout": launches}


# -------------------------------------------------------------- phase 10 --

# The data-parallel fits' data: the first 8296 rows of phase 2's training
# set, 64 whole batches of 128 and a 104-row tail; one unsupervised epoch
# and the readout pass, 130 steps.
DP_ROWS = 8296
# The killed fit checkpoints every 16 batches and dies after its 2nd chunk.
DP_CKPT_EVERY = 16
DP_KILL_CHUNK = 2


def dp_cfgs():
    """Model 1 and Model 1-struct (c) on the plain backend: the DP programs
    compute in plain torch whatever the backend (as the JAX ones do), so
    the single-device references take it too."""
    import dataclasses
    from repro_torch.configs.bcpnn_models import MODEL1_MNIST
    return {"model1": dataclasses.replace(MODEL1_MNIST, backend="torch"),
            "c": dataclasses.replace(struct_cfg("c"), backend="torch")}


def digest(snap) -> str:
    """A hash of a ``train_dp.snapshot`` tree (every array's bytes, the
    clocks and the generator's state), to hold the ranks to each other."""
    import hashlib
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                walk(x[k])
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif isinstance(x, np.ndarray):
            h.update(str(x.dtype).encode() + str(x.shape).encode())
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(repr(x).encode())

    walk(snap)
    return h.hexdigest()


def snapshot_diff(a, b) -> float:
    """Largest absolute difference between two snapshots' arrays."""
    worst = 0.0

    def walk(x, y):
        nonlocal worst
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y):
                walk(u, v)
        elif isinstance(x, np.ndarray) and x.dtype.kind == "f":
            worst = max(worst, float(np.abs(x.astype(np.float64)
                                            - y.astype(np.float64)).max()))

    walk(a["state"], b["state"])
    return worst


def _phase10_rank(rank, device, root):
    """A rank of phase 10's group of four (gloo, all on one card).  After
    an untimed warm-up step it waits for ``root/go`` (the parent writes it
    once the launcher's processes are gone, so the timed fits have the card
    and the host to themselves), then: Model 1's and (c)'s DP fits and the
    Model-1 fit killed after its 2nd chunk on ranks 0 and 1 (a group of
    their own); Model 1's DP fit on all four; Model 1's resume from a
    copy of the killed fit's checkpoints on rank 0 alone, over a group of
    one on NCCL.  Rank 0 returns the snapshots, every rank their
    digests."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import Trainer, init_deep
    from repro_torch.core.network import as_spec
    from repro_torch.distributed import (
        WorkerLost, elastic_mesh, make_data_parallel_unsupervised_step,
        rank_devices)
    from repro_torch.launch.train_dp import snapshot
    z = np.load(os.path.join(root, "data.npz"))
    x, y = z["x"], z["y"]
    cfgs = dp_cfgs()
    spec = as_spec(cfgs["model1"])
    kill_dir = os.path.join(root, "kill")
    devs = rank_devices(4)
    mesh4 = elastic_mesh((4,), ("data",))
    pair = dist.new_group([0, 1])
    alone = dist.new_group([0], backend="nccl")
    mesh2 = elastic_mesh((4,), ("data",), devices=devs[:2]).with_group(pair)
    mesh1 = elastic_mesh((4,), ("data",), devices=devs[:1]).with_group(alone)
    bl = 128 // 4
    x0 = torch.from_numpy(x[rank * bl:(rank + 1) * bl]).to(device)
    unsup4 = make_data_parallel_unsupervised_step(spec, mesh4)
    unsup4(init_deep(spec, 0, device), x0)  # warm-up
    while rank == 0 and not os.path.exists(os.path.join(root, "go")):
        time.sleep(0.1)
    dist.barrier()
    out = {}

    def keep(tag, snap, **extra):
        out[tag] = {"digest": digest(snap), **extra}
        if rank == 0:
            out[tag]["snapshot"] = snap

    def fit(tag, cfg, mesh, seed=0, **kw):
        tr = Trainer(cfg, seed, mesh, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.fit(x, y, epochs=1, batch=128, **kw)
        keep(tag, snapshot(tr.state), stats=stats,
             wall=time.perf_counter() - t0)

    if rank < 2:
        fit("model1_2", cfgs["model1"], mesh2)
        fit("c_2", cfgs["c"], mesh2)
        seen = []

        def boom(cur):
            seen.append(cur)
            if len(seen) == DP_KILL_CHUNK:
                raise WorkerLost(f"killed at {cur}")

        try:
            Trainer(cfgs["model1"], 0, mesh2, device=device).fit(
                x, y, epochs=1, batch=128, ckpt_dir=kill_dir,
                ckpt_every_batches=DP_CKPT_EVERY, on_chunk=boom)
        except WorkerLost:
            out["killed_at"] = seen[-1].to_dict()
    dist.barrier()
    fit("model1_4", cfgs["model1"], mesh4)
    if rank == 0:  # on a copy: the parent's single steps read kill_dir
        import shutil
        resume_dir = shutil.copytree(kill_dir, os.path.join(root, "resume"))
        fit("resumed_1", cfgs["model1"], mesh1, seed=1, ckpt_dir=resume_dir,
            ckpt_every_batches=DP_CKPT_EVERY, resume=True)
    return out


def phase10_reference(torch, cfgs, x, y):
    """The single-device fits of phase 10's configurations on the card:
    each state's snapshot, the fit's stats and wall."""
    from repro_torch.core import Trainer
    from repro_torch.launch.train_dp import snapshot
    ref = {}
    for name, cfg in cfgs.items():
        tr = Trainer(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.fit(x, y, epochs=1, batch=128)
        ref[name] = {"snapshot": snapshot(tr.state), "stats": stats,
                     "wall": time.perf_counter() - t0, "spec": tr.spec}
    return ref


def kernel_accuracy(torch, snap, spec, xte, yte):
    """Test accuracy of a snapshot's state through the kernels
    (``spec.with_backend("cuda")``) and the launches of that evaluation."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import evaluate_padded
    from repro_torch.kernels import ops
    state = state_from_numpy(snap["state"], spec, device="cuda")
    before = ops.launch_counts()
    acc = evaluate_padded(state, spec.with_backend("cuda"), xte, yte)
    after = ops.launch_counts()
    ops.set_launch_counts(before)
    return acc, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def column_blocks(torch):
    """The DP step's products at Model 1's and Model 1-struct's shapes,
    column blocks of n ranks against the same columns of the whole
    product: (elements that differ, max abs difference) per product."""
    from repro_torch.core.compact import compact_co_stats, compact_support
    from repro_torch.core.hypercolumns import LayerGeom, hc_softmax
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {}

    def cmp(name, full, parts, dim):
        d = (torch.cat(parts, dim=dim) - full).abs()
        out[name] = (int((d != 0).sum()), float(d.max()))

    ni, hj, mj = 1568, 32, 128
    w = torch.randn((ni, hj * mj), generator=g, device="cuda")
    for b in (128, 104):
        x = torch.rand((b, ni), generator=g, device="cuda")
        y = torch.rand((b, hj * mj), generator=g, device="cuda")
        s, co = x @ w, x.T @ y
        for n in (2, 4):
            k = hj * mj // n
            blk = [slice(i * k, (i + 1) * k) for i in range(n)]
            cmp(f"x@w B={b} n={n}", s, [x @ w[:, c] for c in blk], 1)
            cmp(f"xT@y B={b} n={n}", co, [x.T @ y[:, c] for c in blk], 1)
            cmp(f"hc_softmax B={b} n={n}", hc_softmax(s, LayerGeom(hj, mj)),
                [hc_softmax(s[:, c].contiguous(), LayerGeom(hj // n, mj))
                 for c in blk], 1)
    nact, mi = 128, 2
    x = torch.rand((128, ni), generator=g, device="cuda")
    y = torch.rand((128, hj * mj), generator=g, device="cuda")
    table = torch.stack([torch.sort(torch.randperm(
        ni // mi, generator=g, device="cuda")[:nact]).values
        for _ in range(hj)]).to(torch.int32)
    w_c = torch.randn((hj, nact * mi, mj), generator=g, device="cuda")
    bias = torch.randn((hj * mj,), generator=g, device="cuda")
    s = compact_support(x, w_c, bias, table, mi)
    co = compact_co_stats(x, y, table, mi, mj)
    for n in (2, 4):
        l = hj // n
        hs = [slice(i * l, (i + 1) * l) for i in range(n)]
        cmp(f"compact support n={n}", s, [compact_support(
            x, w_c[h], bias[h.start * mj:h.stop * mj], table[h], mi)
            for h in hs], 1)
        cmp(f"compact co n={n}", co, [compact_co_stats(
            x, y[:, h.start * mj:h.stop * mj].contiguous(), table[h], mi,
            mj) for h in hs], 0)
    return out


def phase10(torch, data):
    """The data-parallel fit on the card: four rank processes sharing it
    over gloo (``_phase10_rank``) against single-device fits in this
    process; the ranks start up while this process checks the column
    blocks and fits its references, and their timed work waits for those
    to end.  Processes sharing one card measure the protocol, not scaling.
    (The launcher's smoke, ``launcher_start``, runs beside phase 7.)"""
    import shutil
    import tempfile
    from repro_torch.distributed import RankGroup
    xtr, ytr, xte, yte = data
    x, y = xtr[:DP_ROWS], ytr[:DP_ROWS]
    root = Path(tempfile.mkdtemp(prefix="phase10_", dir=ROOT / "build"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    group = None
    try:
        np.savez(root / "data.npz", x=x, y=y)
        group = RankGroup(_phase10_rank, 4, backend="gloo", device="cuda",
                          args=(str(root),), timeout_s=600)
        blocks = column_blocks(torch)
        print("[phase10] column blocks against the whole product "
              "(differing elements, max abs diff): " + "; ".join(
                  f"{k} {c} {d:.3e}" for k, (c, d) in blocks.items())
              + f" ({smi})", flush=True)
        # the dense support is formed whole (x @ w need not be invariant)
        check(all(c == 0 for k, (c, _) in blocks.items()
                  if not k.startswith("x@w")),
              f"a product the DP contract relies on is not "
              f"column-invariant: {blocks}")
        cfgs = dp_cfgs()
        ref = phase10_reference(torch, cfgs, x, y)
        (root / "go").touch()
        ranks = group.join()
        killed = ranks[0].get("killed_at")
        check(killed == {"phase": "unsupervised", "layer": 0, "epoch": 0,
                         "batch": DP_KILL_CHUNK * DP_CKPT_EVERY},
              f"phase 10: the kill came at {killed}, not mid unsupervised "
              f"epoch")
        print(f"[phase10] group of 4 ranks on one card (gloo; NCCL for the "
              f"resume on one) done in {time.perf_counter() - t:.1f} s, "
              f"process start-up included ({smi})", flush=True)
        for tag in ranks[0]:
            if isinstance(ranks[0][tag], dict) and "digest" in ranks[0][tag]:
                holders = [r for r in ranks if tag in r]
                check(all(r[tag]["digest"] == holders[0][tag]["digest"]
                          for r in holders),
                      f"phase 10 {tag}: the ranks' states differ")
        phase10_report(torch, ranks[0], ref, xte, yte, smi)
    finally:
        if group is not None:
            group.close()
        shutil.rmtree(root, ignore_errors=True)


def launcher_start():
    """Phase 10's last check, started before phase 7 to run beside its
    pytest process (neither is timed): ``python -m
    repro_torch.launch.train_dp --smoke --device cuda`` at its defaults, its
    log kept."""
    return start_module(["repro_torch.launch.train_dp", "--smoke", "--device",
                         "cuda"], "train_dp_smoke.log")


def launcher_finish(started):
    proc, log, t = started
    rc = proc.wait(timeout=600)
    lines = log.read_text().strip().splitlines()
    for line in lines:
        if line.startswith("[train-dp]"):
            print(f"[phase10] {line}", flush=True)
    print(f"[phase10] train_dp --smoke: rc {rc} in "
          f"{time.perf_counter() - t:.1f} s, beside phase 7 (log "
          f"{log.relative_to(ROOT)})", flush=True)
    check(rc == 0, f"train_dp --smoke failed: "
                   f"{lines[-1:] or ['(no output)']}")


def phase10_report(torch, got, ref, xte, yte, smi):
    """Each DP state against its single-device reference, the kernel-path
    accuracies, the walls and the collectives' share."""
    from repro_torch.launch.train_dp import snapshots_equal
    n_img = DP_ROWS
    steps = 2 * -(-n_img // 128)
    for tag, name, ranks in (("model1_2", "model1", 2), ("c_2", "c", 2),
                             ("model1_4", "model1", 4),
                             ("resumed_1", "model1", 1)):
        snap, want = got[tag]["snapshot"], ref[name]["snapshot"]
        same = snapshots_equal(snap, want)
        worst = snapshot_diff(snap, want)
        spec = ref[name]["spec"]
        acc, launches = kernel_accuracy(torch, snap, spec, xte, yte)
        acc_ref, _ = kernel_accuracy(torch, want, spec, xte, yte)
        stats, wall = got[tag]["stats"], got[tag]["wall"]
        rs = ref[name]["stats"]
        if tag == "resumed_1":
            print(f"[phase10] Model 1 killed on 2 ranks at {got['killed_at']}"
                  f", resumed on 1 over NCCL: state "
                  f"{'EQUAL' if same else 'differs'} to the uninterrupted "
                  f"single-device fit bit for bit (max abs diff "
                  f"{worst:.3e}); kernel-path test accuracy {acc:.6f} "
                  f"(single-device {acc_ref:.6f}); the resumed part "
                  f"{wall:.3f} s ({smi})", flush=True)
            check(same and acc == acc_ref,
                  f"phase 10: the resumed fit parts from the uninterrupted "
                  f"one (max abs diff {worst:.3e})")
            continue
        label = {"model1_2": "Model 1, 2 ranks", "c_2": "(c), 2 ranks",
                 "model1_4": "Model 1, 4 ranks"}[tag]
        print(f"[phase10] {label}: state {'EQUAL' if same else 'DIFFERS'} "
              f"to the single-device fit bit for bit (every array, mask, "
              f"table, clock, generator; max abs diff {worst:.3e}); kernel-"
              f"path test accuracy {acc:.6f} (single-device {acc_ref:.6f}; "
              f"launches {json.dumps(launches)}); fit {wall:.3f} s, unsup_s "
              f"{stats['unsup_s']:.4f} ({n_img / stats['unsup_s']:.0f} "
              f"images/s) sup_s {stats['sup_s']:.4f}, collectives "
              f"{stats['comm_s']:.3f} s: per step {1e3 * wall / steps:.2f} "
              f"ms, {1e3 * stats['comm_s'] / steps:.2f} in collectives, "
              f"{1e3 * (wall - stats['comm_s']) / steps:.2f} else "
              f"(single-device graphed: fit {ref[name]['wall']:.3f} s, "
              f"unsup_s {rs['unsup_s']:.4f} ({n_img / rs['unsup_s']:.0f} "
              f"images/s) sup_s {rs['sup_s']:.4f}; {smi})", flush=True)
        check(acc == acc_ref, f"phase 10 {label}: accuracy {acc} against "
                              f"the single-device {acc_ref}")
        check(same, f"phase 10 {label}: the DP fit parts from the "
                    f"single-device fit (max abs diff {worst:.3e})")


# -------------------------------------------------------------- phase 11 --

# qwen1.5-0.5b in bf16: decode logits against forward's at the same
# position, as a share of the largest |logit| of forward (1.3 % on the
# H100, PERF.md §6): the two paths round their bf16 products in other
# shapes (one row against the whole sequence) through 24 layers.
QWEN_REL_TOL = 0.05
HEAD_TOL = 1e-4
# Predicted kernel launches of one head call (core/head.py over
# core/network.py on the "cuda" backend): the noisy support is a plain
# matmul, its normalize hc_softmax, the learn one dense update (masked by
# the HC mask at nact_hi < feature_dim); the supervised step's hidden rates
# one forward (patchy at nact_hi < feature_dim) and the readout's learn an
# update; the prediction one forward and the readout's hc_softmax.
HEAD_LAUNCHES = {
    "unsupervised": {"hc_softmax": 1, "bcpnn_update": 1},
    "supervised": {"fwd": 1, "bcpnn_update": 1},
    "predict": {"fwd": 1, "hc_softmax": 1},
}


def phase11(torch):
    """The LM zoo's serving path at full width and the BCPNN head on its
    trunk; returns the head's launches per run (``head_qwen``,
    ``head_qwen_nact256``).  The ten smoke architectures, card against CPU,
    are phase 7's (``test_decode_steps_on_card_match_cpu``)."""
    cfg, params = phase11_qwen(torch)
    return phase11_head(torch, cfg, params)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase11_qwen(torch):
    """qwen1.5-0.5b at its published width and depth in bf16 on the card:
    the launcher's defaults (batch 4, prompt 32 from TokenStream, 16 greedy
    tokens; decode steps under ``set_sync_debug_mode("error")``), decode
    logits against forward's at the same positions, and one prefill of
    8 x 2048 (four query chunks of 512)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import lm
    cfg = get_config("qwen1.5-0.5b")
    check(cfg.dtype == "bfloat16", f"qwen1.5-0.5b's dtype is {cfg.dtype}")
    params, init_ms = _timed(torch, lambda: lm.init_params(cfg, 0, "cuda"))
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[phase11] qwen1.5-0.5b: {len(params.layers)} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} padded to {cfg.vocab_padded}, "
          f"{n_params / 1e9:.3f} G parameters ({n_bytes / 1e9:.3f} GB "
          f"bf16), seeded init on the card in {init_ms:.1f} ms", flush=True)
    batch, prompt_len, gen = 4, 32, 16
    seq_len = prompt_len + gen
    prompts = torch.from_numpy(TokenStream(cfg.vocab, seed=0).batch(
        0, batch, prompt_len)).cuda()

    def serve():
        logits, cache = lm.prefill(params, cfg, prompts, seq_len)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens = torch.argmax(logits, -1)
        out, steps = [tokens], []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(gen - 1):
                logits, cache = lm.decode_step(params, cfg, cache, tokens)
                tokens = torch.argmax(logits, -1)
                out.append(tokens)
                steps.append(logits)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, steps, (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        serve()  # first use: cuBLAS handles and workspaces
        (_, _), prefill_ms = _timed(
            torch, lambda: lm.prefill(params, cfg, prompts, seq_len))
        out, steps, decode_ms = serve()
        gen_toks = torch.stack(out, 1)
        check(bool(torch.isfinite(torch.stack(steps)).all()),
              "phase 11 qwen: non-finite decode logits")
        seq = torch.cat([prompts, gen_toks[:, :-1]], 1)
        ref = lm.logits_for(params, cfg, lm.forward(params, cfg, seq))
        worst, agree = 0.0, 0
        for i, lo in enumerate(steps):
            r = ref[:, prompt_len + i].float()
            worst = max(worst, (lo.float() - r).abs().max().item())
            agree += int((lo.argmax(-1) == r.argmax(-1)).sum())
        scale = ref.float().abs().max().item()
        n_steps = gen - 1
        print(f"[phase11] qwen1.5-0.5b bf16, batch {batch}, prompt "
              f"{prompt_len}, {gen} greedy tokens: prefill {prefill_ms:.2f} "
              f"ms, decode {decode_ms / n_steps:.3f} ms a token "
              f"({n_steps * batch / (decode_ms / 1e3):.1f} tok/s over "
              f"{n_steps} steps, no host sync in a step); decode against "
              f"forward max abs err {worst:.4e} ({worst / scale:.4f} of "
              f"max |logit| {scale:.4f}), argmax equal in {agree} of "
              f"{n_steps * batch}; sample {gen_toks[0, :12].tolist()}",
              flush=True)
        check(worst <= QWEN_REL_TOL * scale,
              f"phase 11 qwen: decode against forward {worst:.4e} > "
              f"{QWEN_REL_TOL} x {scale:.4f}")
        long = torch.from_numpy(TokenStream(cfg.vocab, seed=1).batch(
            0, 8, 2048)).cuda()
        lm.prefill(params, cfg, long[:1, :512], 512)  # first use at length
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # the earlier phases' tensors too
        torch.cuda.reset_peak_memory_stats()
        (lo, cache), long_ms = _timed(
            torch, lambda: lm.prefill(params, cfg, long, 2048))
        check(bool(torch.isfinite(lo).all()), "phase 11: 8x2048 prefill "
                                              "logits not finite")
        check(int(cache.pos) == 2048 and cache.layers[0]["k"].shape ==
              (8, 2048, cfg.n_kv_heads, cfg.head_dim),
              "phase 11: 8x2048 prefill cache shape")
        del cache
        print(f"[phase11] qwen1.5-0.5b bf16 prefill 8x2048 (4 query chunks "
              f"of 512): {long_ms:.2f} ms ({8 * 2048 / (long_ms / 1e3):.0f} "
              f"tokens/s), peak memory in the call "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: the "
              f"call's own "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} "
              f"GiB over the {held / 2**30:.2f} GiB held before it",
              flush=True)
    return cfg, params


def phase11_head(torch, cfg, params):
    """The BCPNN head on the qwen trunk's mean-pooled final hidden states
    (128-row TokenStream batches: feature_dim 1024), with the head config's
    defaults (16 x 64 hidden, 10 classes): one unsupervised step (injected
    noise), one supervised step and a prediction from one state, through
    the kernels ("cuda") and the plain versions ("torch"), dense and with
    nact_hi 256, each call from one state on both paths (the kernel path's
    result of the call before, copied for the plain one: a chain of calls
    on each path would hold each call to the paths' earlier differences,
    which the readout's log-odds of joint traces near 1e-7 amplify); the
    supervised step's hidden rates against fp64; the predicted launches
    of each call; then each call's eager wall time."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.core import head
    from repro_torch.core.graphs import state_tensors
    from repro_torch.core.network import (infer, supervised_step,
                                          unsupervised_step)
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    with torch.no_grad():
        toks = torch.from_numpy(TokenStream(cfg.vocab, seed=2).batch(
            0, 128, 32)).cuda()
        feats = lm.forward(params, cfg, toks).mean(dim=1)
    check(feats.shape == (128, cfg.d_model) and feats.dtype ==
          torch.bfloat16, f"phase 11: pooled features {feats.shape} "
                          f"{feats.dtype}")
    labels = torch.from_numpy(
        np.random.default_rng(3).integers(0, 10, 128)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    runs = {}
    for nact in (0, 256):
        hcfg = head.BCPNNHeadConfig(feature_dim=cfg.d_model, nact_hi=nact)
        net = hcfg.network_config()
        plain = dataclasses.replace(net, backend="torch")
        noise = torch.randn((128, hcfg.hidden_hc * hcfg.hidden_mc),
                            generator=gen, device="cuda")
        st = head.init_head(hcfg, 5, "cuda")
        rates = head.encode_features(feats, hcfg.encode_gain).float()
        fwd = "patchy_forward" if nact else "bcpnn_fwd"
        calls = {
            "unsupervised": (
                lambda s: head.head_unsupervised(s, hcfg, feats, noise=noise),
                lambda s: unsupervised_step(s, plain, rates, noise=noise)),
            "supervised": (
                lambda s: head.head_supervised(s, hcfg, feats, labels),
                lambda s: supervised_step(s, plain, rates, labels)),
            "predict": (lambda s: head.head_predict(s, hcfg, feats),
                        lambda s: infer(s, plain, rates)),
        }
        run = {k: 0 for k in ops.launch_counts()}
        label = f"head_qwen{'_nact256' if nact else ''}"
        for name, (kern, ref_fn) in calls.items():
            st_p = convert.state_from_numpy(convert.state_to_numpy(st), plain,
                                            "cuda")
            if name == "supervised":
                _head_hidden_rates(torch, st, st_p, net, plain, rates, label)
            ops.reset_launch_counts()
            got = kern(st)
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            want = ref_fn(st_p)
            predicted = {fwd if k == "fwd" else k: v
                         for k, v in HEAD_LAUNCHES[name].items()}
            check(counts == predicted, f"phase 11 {label} {name}: launches "
                                       f"{counts}, predicted {predicted}")
            for k, v in counts.items():
                run[k] += v
            if name == "predict":
                (pk, yk), (pp, yp) = got, want
                err = (pk - pp).abs().max().item()
                same = (yk == yp).float().mean().item()
                check(err <= HEAD_TOL and same >= 0.999,
                      f"phase 11 {label} predict: probs {err:.3e}, "
                      f"predictions equal in {same:.4f}")
                extra = f", predictions equal in {same:.4f} of rows"
            else:
                err = max((a.double() - b.double()).abs().max().item()
                          for a, b in zip(state_tensors(got),
                                          state_tensors(want)))
                check(err <= HEAD_TOL, f"phase 11 {label} {name}: state "
                                       f"{err:.3e} > {HEAD_TOL}")
                extra = ""
                if name == "supervised":
                    extra = _head_readout_gap(torch, got, want)
                st = got
            print(f"[phase11] {label} {name}: kernel vs plain max abs err "
                  f"{err:.3e}{extra}; launches {counts} (as predicted)",
                  flush=True)
        runs[label] = run
        walls = {}
        for name, (kern, _) in calls.items():
            for _ in range(3):
                kern(st)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                kern(st)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t) * 1e6 / 20
        print(f"[phase11] {label} eager walls (us a call, 20 calls): "
              + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
              + "; not graphed: core/graphs.py's StepProgram takes donated "
              "steps, the head's calls return new states", flush=True)
    return runs


def _head_hidden_rates(torch, st, st_p, net, plain, rates, label):
    """The supervised step's hidden rates from one state, kernel and plain
    path, each against an fp64 forward (phase 3's rule: the kernel no
    further from fp64 than max(1e-5, twice the plain path))."""
    from repro_torch.core.network import as_spec, stack_rates
    spec = as_spec(net)
    proj, pspec = st.projs[0], spec.projs[0]
    s64 = proj.b.double() + rates.double() @ proj.w.double()  # w is masked
    r64 = torch.softmax(s64.view(len(rates), pspec.post.H, pspec.post.M) *
                        pspec.gain, dim=-1).view(len(rates), -1)
    hk = stack_rates(st, spec, rates)
    hp = stack_rates(st_p, as_spec(plain), rates)
    err_k = (hk.double() - r64).abs().max().item()
    err_p = (hp.double() - r64).abs().max().item()
    print(f"[phase11] {label} supervised step's hidden rates ({len(rates)} "
          f"rows, supports {s64.min().item():.1f} to "
          f"{s64.max().item():.1f}), max abs err vs fp64: kernel "
          f"{err_k:.3e}, plain {err_p:.3e}; kernel vs plain "
          f"{(hk - hp).abs().max().item():.3e}", flush=True)
    check(err_k <= max(1e-5, 2 * err_p),
          f"phase 11 {label}: kernel hidden rates {err_k:.3e} from fp64, "
          f"plain {err_p:.3e}")


def _head_readout_gap(torch, got, want):
    """Where the supervised step's two states part most in the readout's
    w: its joint trace there (w = log pij - log pi - log pj, so a
    difference d in pij moves w by about d / pij)."""
    dw = (got.readout.w.double() - want.readout.w.double()).abs()
    i = int(dw.argmax())
    pij_k = got.readout.traces.pij.reshape(-1)[i].item()
    pij_p = want.readout.traces.pij.reshape(-1)[i].item()
    return (f" (readout w {dw.reshape(-1)[i].item():.3e} apart where pij is "
            f"{pij_k:.6e} against {pij_p:.6e}: d / pij = "
            f"{abs(pij_k - pij_p) / max(pij_p, 1e-30):.3e}; readout pij from "
            f"{got.readout.traces.pij.min().item():.3e})")


def phase11_start():
    """Phase 11's subprocesses, started before phase 7 to run beside its
    pytest process: the serve launcher at full width (``python -m
    repro_torch.launch.serve --arch qwen1.5-0.5b --batch 4 --prompt-len 32
    --gen 16``) and the head example on the card, their logs kept."""
    return [start_module(args, f"{log}.log") for args, log in (
        (["repro_torch.launch.serve", "--arch", "qwen1.5-0.5b", "--batch",
          "4", "--prompt-len", "32", "--gen", "16"], "serve_qwen"),
        (["repro_torch.examples.bcpnn_head_on_lm", "--device", "cuda"],
         "bcpnn_head_on_lm"))]


def phase11_finish(started):
    for (proc, log, t), prefix in zip(started, ("[serve]", "[bcpnn-head]")):
        rc = proc.wait(timeout=600)
        lines = log.read_text().strip().splitlines()
        for line in lines:
            if line.startswith(prefix):
                print(f"[phase11] {line}", flush=True)
        print(f"[phase11] {' '.join(proc.args[2:])}: rc {rc} in "
              f"{time.perf_counter() - t:.1f} s, beside phase 7 (log "
              f"{log.relative_to(ROOT)})", flush=True)
        check(rc == 0, f"{' '.join(proc.args[2:])} failed: "
                       f"{lines[-1:] or ['(no output)']}")


def start_module(args, log_name):
    """``python -m <args>`` from the repo root, its output in
    ``chiprun_out/<log_name>``: (process, log, start time)."""
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    log = ROOT / "chiprun_out" / log_name
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, stdout=f,
            stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


# -------------------------------------------------------------- phase 12 --

# The JAX train driver's defaults (``repro/launch/train.py``): batch 8,
# sequence 256, lr 3e-4; 30 steps, warmup max(1, steps // 20).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 30, 8, 256, 3e-4
COMPRESS_STEPS = 5
PROFILED_STEPS = 3
# the resume: 4 steps, a checkpoint every 2, killed after step 2's
RESUME_ARGS = ["--arch", "qwen1.5-0.5b", "--steps", "4", "--ckpt-every",
               "2", "--device", "cuda"]


def phase12(torch, smi):
    """qwen1.5-0.5b trained at its published width and depth on the card
    (bf16, remat, lmhead chunk 512, tied embeddings) with the JAX driver's
    defaults, through ``launch.steps.make_train_step`` and the driver's
    batches: the median step, tokens/s, the peak of allocated memory, the
    model FLOPs a step against the card's dense bf16 peak (for
    information), the first and last windows of the loss (the windowed
    decrease asserted); where a step's device time goes
    (``torch.profiler``); two gradient passes from one state compared leaf
    by leaf, and the embedding's two backwards (``index_add_``, what
    ``index_select``'s backward runs, and ``F.embedding``'s) repeated on
    the same rows; then ``--compress-grads``' step for a few steps.  The
    driver's kill and resume runs beside phase 7 (``phase12_resume``).
    Returns the peak of allocated bytes over what was held before and the
    profiled device-busy seconds a step (phase 15 holds the dry run's
    estimate and time terms against them)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_leaf_groups
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import lm
    from repro_torch.optim import (AdamWConfig, init_error_state,
                                   init_opt_state)
    cfg = get_config("qwen1.5-0.5b")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab, cfg.tie_embeddings,
           cfg.dtype, cfg.remat, cfg.lmhead_chunk) ==
          (24, 1024, 2816, 151936, True, "bfloat16", True, 512),
          f"phase 12: qwen1.5-0.5b is not the published config: {cfg}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, 0, "cuda", train=True)
    groups = lm_leaf_groups(params)
    n_params = sum(p.numel() for p in params.parameters())
    opt = init_opt_state(groups)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=max(1, TRAIN_STEPS // 20))
    step = make_train_step(cfg, opt_cfg)
    make_batch = make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)

    def batch_of(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in make_batch(i).items()}

    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        batch = batch_of(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, params, opt = step(params, opt, batch)
        losses.append(float(loss))  # the step's one sync
        walls.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"phase 12: non-finite loss {losses}")
    w = max(1, len(losses) // 4)
    head, tail = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    med = statistics.median(walls[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops6 = 6 * n_params * tokens
    print(f"[phase12] qwen1.5-0.5b train, {len(params.layers)} layers, "
          f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
          f"(padded {cfg.vocab_padded}), tied, bf16, remat, lmhead chunk "
          f"{cfg.lmhead_chunk}: {n_params / 1e9:.4f} G parameters; batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, lr {TRAIN_LR}, {TRAIN_STEPS} "
          f"steps: median step {med * 1e3:.2f} ms (steps 2-{TRAIN_STEPS}; "
          f"first {walls[0] * 1e3:.1f} ms), {tokens / med:.0f} tokens/s; "
          f"peak allocated {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f}"
          f" GiB over the {held / 2**30:.2f} GiB held before); model FLOPs a "
          f"step 6N {flops6 / 1e12:.3f} T, 8N with remat "
          f"{flops6 * 4 / 3 / 1e12:.3f} T: {flops6 * 4 / 3 / med / 1e12:.1f} "
          f"TFLOP/s, {flops6 * 4 / 3 / med / PEAK_BF16_FLOP_S:.3f} of the "
          f"dense bf16 peak of {PEAK_BF16_FLOP_S / 1e12:.0f} (information "
          f"only; {smi})", flush=True)
    print(f"[phase12] loss: first {w} steps mean {head:.4f} "
          f"({', '.join(f'{x:.4f}' for x in losses[:w])}), last {w} mean "
          f"{tail:.4f} ({', '.join(f'{x:.4f}' for x in losses[-w:])})",
          flush=True)
    check(tail < head, f"phase 12: the loss did not decrease ({head:.4f} "
                       f"-> {tail:.4f})")

    batch = batch_of(TRAIN_STEPS)
    for _ in range(2):
        step(params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            float(step(params, opt, batch)[0])
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / PROFILED_STEPS
    # the aten operators that launched the device time, by their own share
    ops = sorted((e for e in events if e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    print(f"[phase12] a train step traced ({PROFILED_STEPS} steps): device "
          f"busy {busy / 1e3:.2f} ms a step, idle share "
          f"{max(0.0, 1 - busy / 1e3 / (med * 1e3)):.3f} of the untraced "
          f"median {med * 1e3:.2f} ms, "
          f"{sum(e.count for e in kernels) / PROFILED_STEPS:.0f} kernels a "
          f"step; top operators by device time a step: " + "; ".join(
              f"{e.key} {e.self_device_time_total / PROFILED_STEPS / 1e3:.2f}"
              f" ms ({e.count // PROFILED_STEPS} calls)" for e in ops),
          flush=True)

    phase12_determinism(torch, F, params, cfg, batch)

    opt["err"] = init_error_state(groups)
    cstep = make_train_step(cfg, opt_cfg, compress=True)
    closses, cwalls = [], []
    for i in range(COMPRESS_STEPS):
        batch = batch_of(TRAIN_STEPS + 1 + i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, params, opt = cstep(params, opt, batch)
        closses.append(float(loss))
        cwalls.append(time.perf_counter() - t)
    check(all(np.isfinite(closses)), f"phase 12: compressed steps' losses "
                                     f"{closses}")
    print(f"[phase12] --compress-grads (int8, one scale a JAX leaf, error "
          f"feedback): {COMPRESS_STEPS} steps from the trained state, "
          f"losses {', '.join(f'{x:.4f}' for x in closses)}, median step "
          f"{statistics.median(cwalls[1:]) * 1e3:.2f} ms ({smi})", flush=True)
    del params, opt, groups, step, cstep, batch
    torch.cuda.empty_cache()
    return peak - held, busy * 1e-6


def phase12_determinism(torch, F, params, cfg, batch):
    """Two gradient passes from one state on one batch, leaf by leaf; and
    the embedding's backward rows summed twice by ``index_add_`` (the
    backward of ``index_select``: atomics) and by ``F.embedding``'s
    backward, on the batch's tokens, against each other."""
    from repro_torch.convert import lm_leaf_groups
    from repro_torch.models import lm
    groups = lm_leaf_groups(params)
    flat = [t for g in groups.values() for t in g]
    names = [k for k, g in groups.items() for _ in g]
    runs = []
    for _ in range(2):
        loss = lm.lm_loss(params, cfg, batch["tokens"])
        runs.append(torch.autograd.grad(loss, flat))
    differ = sorted({n for n, a, b in zip(names, *runs)
                     if not torch.equal(a, b)})
    toks = batch["tokens"].reshape(-1)
    rows = torch.randn((toks.numel(), cfg.d_model), device="cuda",
                       dtype=params.tok_embed.dtype)
    table = params.tok_embed.detach()

    def index_add():
        return torch.zeros_like(table).index_add_(0, toks.long(), rows)

    def embedding():
        t = table.clone().requires_grad_(True)
        F.embedding(toks, t).backward(rows)
        return t.grad

    ia = [index_add() for _ in range(3)]
    em = [embedding() for _ in range(3)]
    ia_same = all(torch.equal(ia[0], x) for x in ia[1:])
    em_same = all(torch.equal(em[0], x) for x in em[1:])
    print(f"[phase12] two gradient passes from one state: "
          f"{len(flat) - sum(not torch.equal(a, b) for a, b in zip(*runs))}"
          f" of {len(flat)} tensors equal bit for bit"
          f"{'; differ: ' + ', '.join(differ) if differ else ''}; the "
          f"embedding backward of {toks.numel()} rows ({int(toks.unique().numel())}"
          f" distinct tokens) repeated 3 times: index_add_ (index_select's "
          f"backward) {'equal' if ia_same else 'DIFFERS'}, F.embedding's "
          f"{'equal' if em_same else 'DIFFERS'}", flush=True)
    check(not differ and em_same, f"phase 12: a train step's gradients are "
                                  f"not repeatable: {differ}")


def phase12_resume():
    """The driver at full width, killed after a checkpoint and restarted,
    against an uninterrupted run (``RESUME_ARGS``), on a thread beside
    phase 7: the uninterrupted and the killed run start together; the
    killed one gets SIGKILL once its step-2 checkpoint is on disk, and its
    restart resumes from it.  The final checkpoints are compared leaf by
    leaf.  Returns (thread, result dict)."""
    import shutil
    import tempfile
    import threading
    root = Path(tempfile.mkdtemp(prefix="phase12_", dir=ROOT / "build"))
    result = {"procs": []}

    def launch(name, log):
        started = start_module(["repro_torch.launch.train", *RESUME_ARGS,
                                "--ckpt-dir", str(root / name)], log)
        result["procs"].append(started[0])
        return started

    def run():
        t = time.perf_counter()
        try:
            whole = launch("whole", "train_qwen_whole.log")
            killed = launch("killed", "train_qwen_killed.log")
            while not (root / "killed" / "step_2").exists():
                if killed[0].poll() is not None:
                    raise RuntimeError("the run to kill ended first")
                time.sleep(0.05)
            killed[0].kill()
            killed[0].wait()
            result["killed_at"] = sorted(
                p.name for p in (root / "killed").iterdir())
            resumed = launch("killed", "train_qwen_resumed.log")
            result["rc"] = (whole[0].wait(timeout=900),
                            resumed[0].wait(timeout=900))
            result["logs"] = [whole[1], killed[1], resumed[1]]
            a = np.load(root / "whole" / "step_4" / "arrays.npz")
            b = np.load(root / "killed" / "step_4" / "arrays.npz")
            differ, worst = [], 0.0
            for name in a.files:
                x, y = a[name], b[name]
                if x.tobytes() != y.tobytes():
                    differ.append(name)
                    worst = max(worst, float(np.abs(
                        x.astype(np.float64) - y).max()))
            result.update(leaves=len(a.files), differ=differ, worst=worst,
                          same_names=sorted(a.files) == sorted(b.files))
        except Exception as e:  # reported by phase12_resume_finish
            result["error"] = repr(e)
        finally:
            result["s"] = time.perf_counter() - t
            shutil.rmtree(root, ignore_errors=True)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, result


def phase12_resume_finish(started):
    thread, result = started
    thread.join(timeout=1200)
    check(not thread.is_alive(), "phase 12 resume: still running")
    for log in result.get("logs", []):
        for line in log.read_text().strip().splitlines():
            if line.startswith("[train]"):
                print(f"[phase12] {log.stem}: {line}", flush=True)
    check("error" not in result, f"phase 12 resume: {result.get('error')}")
    print(f"[phase12] the driver killed after its step-2 checkpoint "
          f"(directory at the kill: {result['killed_at']}) and restarted, "
          f"against the uninterrupted 4 steps: {result['leaves']} leaves, "
          f"{len(result['differ'])} differ (max abs {result['worst']:.3e})"
          f"{': ' + ', '.join(result['differ'][:8]) if result['differ'] else ''}"
          f"; rc {result['rc']}; {result['s']:.1f} s beside phase 7",
          flush=True)
    check(result["rc"] == (0, 0) and result["same_names"],
          f"phase 12 resume: rc {result['rc']}")
    check(result["killed_at"] == ["step_2"] or result["killed_at"] == [
        ".tmp_step_4", "step_2"], f"phase 12: the kill came at "
                                  f"{result['killed_at']}")
    check(not result["differ"], f"phase 12: the resumed run parts from the "
                                f"uninterrupted one in {result['differ']}")


# --------------------------------------------------------------- phase 7 --

# -------------------------------------------------------------- phase 13 --

P13_MESH = (2, 2)
P13_STEPS, P13_KILL = 4, 2
P13_SERVE = (4, 32, 16)      # prefill batch, prompt, greedy tokens
P13_REL = 0.04               # PERF.md section 2's bf16 rows
P13_TIMEOUT_S = 900


def _p13_bytes(t):
    """(this rank's bytes, the whole tensor's bytes) of a tensor."""
    from torch.distributed.tensor import DTensor
    local = t.to_local() if isinstance(t, DTensor) else t
    return (local.numel() * local.element_size(),
            t.numel() * t.element_size())


def _p13_digests(groups):
    """sha1 of this rank's block of every tensor of ``groups`` (a dict of
    lists), in order."""
    import hashlib
    import torch
    from torch.distributed.tensor import DTensor
    out = []
    for g in groups.values():
        for t in g:
            local = t.to_local() if isinstance(t, DTensor) else t
            raw = local.detach().contiguous().view(-1).view(torch.uint8)
            out.append(hashlib.sha1(raw.cpu().numpy().tobytes()).hexdigest())
    return out


def _p13_change(got, want, before, mu, opt_cfg):
    """A parameter leaf's change in one split step against the one-rank
    change from the same ``before`` (bf16 values as fp32; ``mu`` the
    one-rank first moment after the step): (the largest difference over
    its bound, everywhere; the same where the step is sure; how many
    elements are sure).  Everywhere the bound is 2 * lr * (1 + wd * |p|)
    (a gradient near zero takes either sign) plus two bf16 ulps of the
    parameter.  An element is sure where |mu| exceeds 4 * P13_REL of the
    leaf's largest (beyond the gradient tolerance: the sign is the same)
    and its clipped gradient 1e3 * eps (Adam's ratio within 1e-3 of
    one): there both sides subtract lr times the same ratio, and the
    bound is one bf16 ulp plus 2e-3 * lr."""
    import torch
    lr, wd = opt_cfg.lr, opt_cfg.weight_decay
    ulp = torch.ldexp(torch.ones_like(before),
                      torch.frexp(torch.maximum(before.abs(), want.abs()))
                      .exponent - 8)
    err = (got - want).abs()
    everywhere = float((err / (2 * lr * (1 + wd * before.abs())
                               + 2 * ulp)).max())
    a = mu.abs()
    sure = (a > 4 * P13_REL * float(a.max())) & (
        a / (1 - opt_cfg.b1) > 1e3 * opt_cfg.eps)
    n = int(sure.sum())
    worst = float((err[sure] / (ulp[sure] + 2e-3 * lr)).max()) if n else 0.0
    return everywhere, worst, n


def _phase13_rank(rank, device, root, small=False):
    """A rank of phase 13's group of four (gloo, all on one card), on the
    (data 2, model 2) mesh: qwen1.5-0.5b at full width trained and served
    split, against the one-rank computation that rank 0 makes on the card
    from the same seed.  Returns rank 0's report (every rank its own
    bytes, peak and digests)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_leaf_groups
    from repro_torch.distributed.sharding import (
        CollectiveMeter, Mesh, full_value, make_rules, place_like,
        rank_devices, sharding_context)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_batch_fn, place_batch
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, global_norm, init_opt_state
    cfg = get_config("qwen1.5-0.5b")
    if small:  # a rehearsal on the CPU: the smoke config, same code
        from repro_torch.configs import smoke
        cfg = smoke(cfg)
    cuda = device.type == "cuda"
    devs = np.empty(4, dtype=object)
    devs[:] = rank_devices(4)
    mesh = Mesh(devs.reshape(P13_MESH), ("data", "model"))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=P13_STEPS,
                          warmup_steps=max(1, P13_STEPS // 20))
    make_batch = make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    lead = rank == 0
    out = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()

    def free():
        if cuda:
            torch.cuda.empty_cache()

    def grads_of(params, batch):
        groups = lm_leaf_groups(params)
        flat = [t for g in groups.values() for t in g]
        loss = lm.lm_loss(params, cfg, batch["tokens"])
        got = iter(torch.autograd.grad(loss, flat))
        return loss.detach(), {k: [next(got) for _ in g]
                               for k, g in groups.items()}

    # -- one split step against the one-rank step, from the seed-0 state
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with sharding_context(mesh, make_rules(mesh)):
        params = lm.init_params(cfg, 0, device, train=True)
        opt = init_opt_state(lm_leaf_groups(params))
        step = make_train_step(cfg, opt_cfg)
        batch0 = place_batch(make_batch(0), device)
        loss_s, grads = grads_of(params, batch0)
        loss_s = float(full_value(loss_s))
        gnorm_s = float(full_value(global_norm(grads)))
    ref = ref0 = ref_opt = None
    if lead:  # the one-rank reference, on the card, outside the mesh
        ref = lm.init_params(cfg, 0, device, train=True)
        ref0 = {k: [t_.detach().clone() for t_ in g]
                for k, g in lm_leaf_groups(ref).items()}
        plain0 = {k: torch.from_numpy(v).to(device)
                  for k, v in make_batch(0).items()}
        loss_1, ref_grads = grads_of(ref, plain0)
        out["loss"] = (loss_s, float(loss_1))
        out["gnorm"] = (gnorm_s, float(global_norm(ref_grads)))
        ref_opt = init_opt_state(lm_leaf_groups(ref))
        make_train_step(cfg, opt_cfg)(ref, ref_opt, plain0)
    sync()
    gerr, perr, merr = {}, {}, {}
    by = {"params": [0, 0], "moments": [0, 0], "grads": [0, 0]}
    with sharding_context(mesh, make_rules(mesh)):
        for path, g in grads.items():
            for i, t_ in enumerate(g):
                mine, whole_b = _p13_bytes(t_)
                by["grads"][0] += mine
                by["grads"][1] += whole_b
                whole = full_value(t_).float()
                if lead:
                    want = ref_grads[path][i].float()
                    gerr[f"{path}[{i}]"] = (
                        float((whole - want).abs().max()),
                        float(want.abs().max()))
                del whole
        del grads
        if lead:
            del ref_grads
        sync()
        t = time.perf_counter()
        loss0, params, opt = step(params, opt, batch0)
        sync()
        first_step = time.perf_counter() - t
        ref_groups = lm_leaf_groups(ref) if lead else None
        for path, g in lm_leaf_groups(params).items():
            for i, t_ in enumerate(g):
                whole = full_value(t_.detach()).float()
                if lead:
                    perr[f"{path}[{i}]"] = _p13_change(
                        whole, ref_groups[path][i].detach().float(),
                        ref0[path][i].float(), ref_opt["mu"][path][i],
                        opt_cfg)
        for key in ("mu", "nu"):
            for path, g in opt[key].items():
                for i, t_ in enumerate(g):
                    whole = full_value(t_)
                    if lead:
                        want = ref_opt[key][path][i]
                        merr[f"{key}/{path}[{i}]"] = (
                            float((whole - want).abs().max()),
                            float(want.abs().max()))
        # -- bytes a rank holds against what the placements give
        want_b = want_m = 0
        for g in lm_leaf_groups(params).values():
            for t_ in g:
                mine, whole_b = _p13_bytes(t_)
                by["params"][0] += mine
                by["params"][1] += whole_b
                n = t_.numel()
                for i, p in enumerate(t_.placements):
                    if p.is_shard():
                        n //= mesh.devices.shape[i]
                want_b += n * t_.element_size()
                want_m += n * 8  # fp32 mu and nu
        for key in ("mu", "nu"):
            for g in opt[key].values():
                for t_ in g:
                    mine, whole_b = _p13_bytes(t_)
                    by["moments"][0] += mine
                    by["moments"][1] += whole_b
        del params, opt
    if lead:  # the one-rank run on to P13_STEPS, the split run's twin
        one_step = make_train_step(cfg, opt_cfg)
        out["one_losses"] = [float(loss_1)] + [
            float(one_step(ref, ref_opt, {
                k: torch.from_numpy(v).to(device)
                for k, v in make_batch(i).items()})[0])
            for i in range(1, P13_STEPS)]
    del ref, ref0, ref_opt, ref_groups
    free()
    out.update(grads=gerr, params=perr, moments=merr,
               first_step=first_step, step_loss=float(loss0),
               bytes={k: tuple(v) for k, v in by.items()},
               param_bytes_by_placements=want_b,
               moment_bytes_by_placements=want_m)

    # -- P13_STEPS split steps from the start (the run the kill-resume
    #    checks), a checkpoint after step P13_KILL, then one measured step
    ckpt = os.path.join(root, "ckpt")
    walls, losses = [], []
    with sharding_context(mesh, make_rules(mesh)):
        params = lm.init_params(cfg, 0, device, train=True)
        opt = init_opt_state(lm_leaf_groups(params))
        mgr = CheckpointManager(ckpt)
        save_s = None
        for i in range(P13_STEPS):
            batch = place_batch(make_batch(i), device)
            sync()
            t = time.perf_counter()
            loss, params, opt = step(params, opt, batch)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t)
            if i + 1 == P13_KILL:
                sync()
                t = time.perf_counter()
                mgr.save(P13_KILL, {"params": params, "opt": opt})
                save_s = time.perf_counter() - t
        whole_run = _p13_digests({**lm_leaf_groups(params), **{
            f"mu/{k}": v for k, v in opt["mu"].items()}, **{
            f"nu/{k}": v for k, v in opt["nu"].items()},
            "step": [opt["step"]]})
        meter = CollectiveMeter()
        batch = place_batch(make_batch(P13_STEPS), device)
        sync()
        t = time.perf_counter()
        with meter:
            step(params, opt, batch)
        sync()
        metered = time.perf_counter() - t
        del params, opt
        free()

        # -- killed after the checkpoint: a fresh state, restored, resumed
        params = lm.init_params(cfg, 1, device, train=True)
        opt = init_opt_state(lm_leaf_groups(params))
        sync()
        t = time.perf_counter()
        CheckpointManager(ckpt).restore(P13_KILL, {"params": params,
                                                   "opt": opt})
        restore_s = time.perf_counter() - t
        for i in range(P13_KILL, P13_STEPS):
            _, params, opt = step(params, opt,
                                  place_batch(make_batch(i), device))
        resumed = _p13_digests({**lm_leaf_groups(params), **{
            f"mu/{k}": v for k, v in opt["mu"].items()}, **{
            f"nu/{k}": v for k, v in opt["nu"].items()},
            "step": [opt["step"]]})
        del params, opt
        free()
    out.update(walls=walls, losses=losses, save_s=save_s,
               restore_s=restore_s, resume_equal=resumed == whole_run,
               n_leaves=len(whole_run), metered_s=metered,
               comm_s=meter.seconds, comm_counts=dict(meter.counts))
    sync()
    if lead:  # the same checkpoint restored on one rank
        ref = lm.init_params(cfg, 1, device, train=True)
        ref_opt = init_opt_state(lm_leaf_groups(ref))
        CheckpointManager(ckpt).restore(P13_KILL, {"params": ref,
                                                   "opt": ref_opt})
        arrays = np.load(os.path.join(ckpt, f"step_{P13_KILL}",
                                      "arrays.npz"))
        from repro_torch.convert import stack_leaf
        same, n = True, 0
        for prefix, tree in (("params", lm_leaf_groups(ref)),
                             ("opt/mu", ref_opt["mu"]),
                             ("opt/nu", ref_opt["nu"])):
            for path, g in tree.items():
                a = stack_leaf(g)
                same &= a.tobytes() == arrays[f"{prefix}/{path}"].tobytes()
                n += 1
        same &= int(ref_opt["step"]) == int(arrays["opt/step"])
        out["one_rank_restore"] = (bool(same), n + 1)
        del ref, ref_opt
        free()
    sync()

    # -- split serving: prefill and greedy decode against one rank
    b, prompt, gen = P13_SERVE
    from repro_torch.data.pipeline import TokenStream
    toks = TokenStream(cfg.vocab, seed=0).batch(0, b, prompt)
    with torch.no_grad():
        one_logits, one_tokens = [], []
        if lead:
            ref = lm.init_params(cfg, 0, device)
            logits, cache = lm.prefill(ref, cfg, torch.from_numpy(toks).to(
                device), prompt + gen)
            for _ in range(gen):
                one_logits.append(logits.float())
                tok = torch.argmax(logits, -1)
                one_tokens.append(tok)
                logits, cache = lm.decode_step(ref, cfg, cache, tok)
            del ref, cache
            free()
            drive = torch.stack(one_tokens, 0).cpu().numpy()
        else:
            drive = np.zeros((gen, b), np.int64)
        drive_t = torch.from_numpy(drive).to(device)
        dist.broadcast(drive_t, 0)  # the one-rank tokens drive both
        with sharding_context(mesh, make_rules(mesh)):
            params = lm.init_params(cfg, 0, device)
            sync()
            t = time.perf_counter()
            logits, cache = lm.prefill(params, cfg, place_like(
                torch.from_numpy(toks).to(device), ("batch", None)),
                prompt + gen)
            sync()
            prefill_s = time.perf_counter() - t
            errs, differ = [], 0
            t = time.perf_counter()
            for i in range(gen):
                whole = full_value(logits).float()
                if lead:
                    errs.append((float((whole - one_logits[i]).abs().max()),
                                 float(one_logits[i].abs().max())))
                    differ += int((torch.argmax(whole, -1)
                                   != one_tokens[i]).sum())
                logits, cache = lm.decode_step(
                    params, cfg, cache, place_like(drive_t[i], ("batch",)))
            sync()
            decode_s = time.perf_counter() - t
            del params, cache
    out.update(serve_err=errs, serve_differ=differ, prefill_s=prefill_s,
               decode_s=decode_s,
               peak=torch.cuda.max_memory_allocated() if cuda else 0)
    return out


def phase13(torch, smi, device="cuda", small=False):
    """The LM zoo on a split mesh: four rank processes sharing the card
    over gloo (``RankGroup``, as phase 10), on (data 2, model 2), each
    holding a quarter of qwen1.5-0.5b at full width (FSDP over data,
    tensor parallelism over model: ``_phase13_rank``).  ``device="cpu"``
    with ``small`` rehearses it on the CPU at the smoke size.  Returns
    every rank's report (phase 15 reads the bytes and peaks)."""
    import shutil
    import tempfile
    from repro_torch.distributed import RankGroup
    root = Path(tempfile.mkdtemp(prefix="phase13_", dir=ROOT / "build"))
    t = time.perf_counter()
    try:
        ranks = RankGroup(_phase13_rank, 4, backend="gloo", device=device,
                          args=(str(root), small),
                          timeout_s=P13_TIMEOUT_S).join()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t
    r = ranks[0]
    split, one = r["loss"]
    gworst = max(e / max(m, 1e-30) for e, m in r["grads"].values())
    mworst = max(e / max(m, 1e-30) / (2 if k.startswith("nu/") else 1)
                 for k, (e, m) in r["moments"].items())
    gn_s, gn_1 = r["gnorm"]
    every = max(v[0] for v in r["params"].values())
    sure = max(v[1] for v in r["params"].values())
    n_sure = sum(v[2] for v in r["params"].values())
    print(f"[phase13] qwen1.5-0.5b (published width and depth, bf16, remat)"
          f" split over (data {P13_MESH[0]}, model {P13_MESH[1]}), four "
          f"ranks sharing the card over gloo, against one rank on the card "
          f"from seed 0: loss {split:.6f} vs {one:.6f} (rel "
          f"{abs(split - one) / abs(one):.2e}); gradients' global norm "
          f"{gn_s:.6f} vs {gn_1:.6f} (rel {abs(gn_s - gn_1) / gn_1:.2e}); "
          f"worst gradient leaf {gworst:.3e} of its largest; worst mu leaf "
          f"after the step and half the worst nu leaf {mworst:.3e} of its "
          f"largest (limit {P13_REL} each, PERF.md section 2; "
          f"{len(r['grads'])} leaves); each parameter's change against the "
          f"one-rank change: worst {every:.3f} of its bound everywhere "
          f"(2 lr (1 + wd |p|) + 2 bf16 ulps), {sure:.3f} of its bound on "
          f"the {n_sure} elements where the step is sure (one bf16 ulp + "
          f"2e-3 lr; {smi})", flush=True)
    check(abs(split - one) <= P13_REL * abs(one),
          f"phase 13: split loss {split} against {one}")
    check(abs(gn_s - gn_1) <= P13_REL * gn_1,
          f"phase 13: split global norm {gn_s} against {gn_1}")
    check(gworst <= P13_REL, f"phase 13: a gradient leaf differs by "
                             f"{gworst:.3e} of its largest")
    check(mworst <= P13_REL, f"phase 13: a moment leaf differs by "
                             f"{mworst:.3e} of its largest (nu halved)")
    check(every <= 1.0, f"phase 13: a parameter's change is {every:.3f} of "
                        f"its bound from the one-rank change")
    check(n_sure > 0 and sure <= 1.0,
          f"phase 13: a sure parameter's change is {sure:.3f} of its bound "
          f"from the one-rank change ({n_sure} sure)")
    mine, whole = r["bytes"]["params"]
    print(f"[phase13] bytes a rank holds (rank by rank): " + "; ".join(
        f"rank {i}: params {q['bytes']['params'][0] / 2**20:.1f} MiB, "
        f"moments {q['bytes']['moments'][0] / 2**20:.1f} MiB, grads "
        f"{q['bytes']['grads'][0] / 2**20:.1f} MiB "
        f"({q['bytes']['params'][0] / q['bytes']['params'][1]:.4f} of one "
        f"rank's), peak allocated {q['peak'] / 2**30:.2f} GiB"
        for i, q in enumerate(ranks)) + f"; the placements give "
        f"{r['param_bytes_by_placements'] / 2**20:.1f} MiB of parameters a "
        f"rank of {whole / 2**20:.1f} MiB ({smi})", flush=True)
    check(all(q["bytes"]["params"][0] == r["param_bytes_by_placements"]
              for q in ranks), "phase 13: a rank holds other parameter "
                               "bytes than its placements give")
    check(all(q["bytes"]["moments"][0] == r["moment_bytes_by_placements"]
              and q["bytes"]["grads"][0] == q["bytes"]["params"][0]
              for q in ranks), "phase 13: moments or gradients are not "
                               "placed as their parameters")
    med = statistics.median(r["walls"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[phase13] {P13_STEPS} split steps (batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, lr {TRAIN_LR}): median {med * 1e3:.1f} ms "
          f"({', '.join(f'{w * 1e3:.1f}' for w in r['walls'])}), "
          f"{tokens / med:.0f} tokens/s; losses "
          f"{', '.join(f'{x:.4f}' for x in r['losses'])}; one step under "
          f"the collective meter {r['metered_s'] * 1e3:.1f} ms, "
          f"{r['comm_s'] * 1e3:.1f} ms ({r['comm_s'] / r['metered_s']:.3f})"
          f" in {sum(r['comm_counts'].values())} collectives "
          f"{json.dumps(r['comm_counts'], sort_keys=True)} (ranks sharing "
          f"one card over gloo: the protocol, not scaling; {smi})",
          flush=True)
    check(all(np.isfinite(r["losses"])), "phase 13: a non-finite loss")
    lworst = max(abs(a - b) / abs(b)
                 for a, b in zip(r["losses"], r["one_losses"]))
    print(f"[phase13] the same {P13_STEPS} steps on one rank: losses "
          f"{', '.join(f'{x:.4f}' for x in r['one_losses'])}; the split "
          f"run's within {lworst:.2e} of them (limit {P13_REL})", flush=True)
    check(lworst <= P13_REL, f"phase 13: the split run's losses part from "
                             f"the one-rank run's by {lworst:.2e}")
    resume_ok = all(q["resume_equal"] for q in ranks)
    same1, n1 = r["one_rank_restore"]
    print(f"[phase13] killed after the step-{P13_KILL} checkpoint (saved in "
          f"{r['save_s']:.1f} s, restored in {r['restore_s']:.1f} s) and "
          f"resumed on the same mesh: every rank's block of all "
          f"{r['n_leaves']} leaves {'EQUAL' if resume_ok else 'DIFFERS'} to "
          f"the uninterrupted split run bit for bit; the checkpoint restored"
          f" on one rank: {n1} leaves {'EQUAL' if same1 else 'DIFFER'} to "
          f"the saved arrays bit for bit", flush=True)
    check(resume_ok, "phase 13: the resumed split run parts from the "
                     "uninterrupted one")
    check(same1, "phase 13: the one-rank restore differs from the saved "
                 "arrays")
    b, prompt, gen = P13_SERVE
    worst = max(e / m for e, m in r["serve_err"])
    print(f"[phase13] split serving: prefill {b} x {prompt} in "
          f"{r['prefill_s'] * 1e3:.1f} ms, {gen} decode steps in "
          f"{r['decode_s'] * 1e3:.1f} ms (the logits gathered each step for "
          f"the comparison), driven by the one-rank greedy tokens: logits "
          f"within {worst:.4f} of the largest (limit {P13_REL}), "
          f"{r['serve_differ']} of {b * gen} greedy tokens differ; phase "
          f"13 took {wall:.1f} s, process start-up included ({smi})",
          flush=True)
    check(worst <= P13_REL, f"phase 13: split logits differ by {worst:.4f} "
                            f"of the largest")
    return ranks


# -------------------------------------------------------------- phase 14 --

# The four Table-1 presets no earlier phase runs, as published (layout
# (a)): Model 2 (pneumonia, 784x2 -> 32x256 -> 2, 20 epochs), Model 3
# (breast, 4096x2 -> 32x128 -> 2, 100 epochs) and their -struct variants
# (nact 128, a rewire every 16 and every 8 steps).
TABLE1_PRESETS = ("model2-pneumonia", "model3-breast",
                  "model2-pneumonia-struct", "model3-breast-struct")
# (train rows, test rows, side) of ``load_or_synthesize``'s table; the data
# is ``make_synthetic(train, test, side, 2, seed=0)``.
TABLE1_DATA = {"pneumonia": (4708, 624, 28), "breast": (546, 156, 64)}
TABLE1_BATCH = 64
# The JAX medical example's evaluation batch.
TABLE1_EVAL_BATCH = {"pneumonia": 64, "breast": 52}
# Test accuracy of the JAX package's own fits (jnp backend, on the CPU;
# the same data, seed and protocol), printed by ``python
# tests/test_torch_table1.py --reference-accuracy``; the port's fit must
# reach it less ACC_SLACK.
JAX_TABLE1_TEST_ACC = {"model2-pneumonia": 1.0, "model3-breast": 0.8462,
                       "model2-pneumonia-struct": 0.9936,
                       "model3-breast-struct": 0.8974}
# Launches of one fit and the evaluation of its train and test rows,
# predicted from the protocol.  Model 2: 4708 rows are 73 batches of 64
# and a 36-row tail, 74 steps an epoch: 1480 unsupervised steps (an update
# and an hc_softmax each), 74 readout steps (a hidden forward and an update
# each), evaluation of 74 + 10 batches (624 = 9 x 64 + 48; a hidden
# forward and the readout's hc_softmax each).  Model 3: 546 rows are 8
# batches and a 34-row tail, 9 steps: 900 unsupervised steps, 9 readout
# steps, evaluation at batch 52 of 11 + 3 batches.  The -struct presets in
# layout (a) take the patchy forward where the others take the dense one;
# their unsupervised support is a plain masked product, as Model 1-struct's.
TABLE1_LAUNCHES = {
    "model2-pneumonia": {"bcpnn_fwd": 158, "bcpnn_update": 1554,
                         "hc_softmax": 1564},
    "model3-breast": {"bcpnn_fwd": 23, "bcpnn_update": 909,
                      "hc_softmax": 914},
    "model2-pneumonia-struct": {"patchy_forward": 158, "bcpnn_update": 1554,
                                "hc_softmax": 1564},
    "model3-breast-struct": {"patchy_forward": 23, "bcpnn_update": 909,
                             "hc_softmax": 914},
}
# Rewires in one fit: at every multiple of struct_every of the trace clock,
# 1480 // 16 and 900 // 8.
TABLE1_REWIRES = {"model2-pneumonia-struct": 92, "model3-breast-struct": 112}
# Replayed unsupervised steps of the no-sync check: past two rewires of
# Model 3-struct and one of Model 2-struct.
TABLE1_NO_SYNC_STEPS = 20
# int8 accumulator and rates tolerance of phase 1's int8 rows.
QUANT_TOL = 1e-6


def table1_data():
    """{dataset: (x_train, y_train, x_test, y_test)}, encoded."""
    from repro_torch.data.synthetic import encode_images, make_synthetic
    data = {}
    for dataset, (n_train, n_test, side) in TABLE1_DATA.items():
        ds = make_synthetic(n_train, n_test, side, 2, seed=0)
        data[dataset] = (encode_images(ds.x_train), ds.y_train,
                         encode_images(ds.x_test), ds.y_test)
    return data


def table1_fit(torch, name, data):
    """The preset's fit at its paper epochs and batch 64 through
    ``Trainer``, then ``evaluate`` of its train and test rows: launches and
    rewires as predicted, the graphed fit equal to the eager loop, test
    accuracy at least the JAX reference's less ACC_SLACK.  Returns the
    trainer and the launches."""
    from repro_torch.configs.bcpnn_models import BCPNN_MODELS
    from repro_torch.core import Trainer
    from repro_torch.kernels import ops
    cfg, dataset, epochs = BCPNN_MODELS[name]
    xtr, ytr, xte, yte = data[dataset]
    eb = TABLE1_EVAL_BATCH[dataset]
    ops.reset_launch_counts()
    t = time.perf_counter()
    tr = Trainer(cfg, seed=0, device="cuda")
    mask0 = tr.state.projs[0].mask.clone()
    version0 = tr.state.projs[0].mask._version
    stats = tr.fit(xtr, ytr, epochs=epochs, batch=TABLE1_BATCH)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t
    acc_train = tr.evaluate(xtr, ytr, batch=eb)
    acc_test = tr.evaluate(xte, yte, batch=eb)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    moved = ""
    if name in TABLE1_REWIRES:
        n = check_masks(tr, mask0, version0, name, TABLE1_REWIRES[name])
        moved = f"; {TABLE1_REWIRES[name]} rewires moved {n} pre-HCs"
    print(f"[phase14] {name}: {epochs} epochs at batch {TABLE1_BATCH} over "
          f"{len(xtr)} rows (the paper's), unsup_s {stats['unsup_s']:.4f}  "
          f"sup_s {stats['sup_s']:.4f}  train_ms_per_img "
          f"{stats['train_ms_per_img']:.6f}  (fit {t_fit:.3f} s incl. "
          f"init); accuracy train {acc_train:.4f} test {acc_test:.4f} "
          f"(evaluation batch {eb}){moved}; launches {json.dumps(got)}",
          flush=True)
    want = {k: TABLE1_LAUNCHES[name].get(k, 0) for k in got}
    check(got == want, f"{name}: launches {got}, predicted {want}")
    graphed_vs_eager(torch, f"[phase14] {name}", tr, stats, cfg, xtr, ytr,
                     xte, yte, epochs=epochs, batch=TABLE1_BATCH,
                     eval_batch=eb)
    floor = JAX_TABLE1_TEST_ACC[name] - ACC_SLACK
    check(acc_test >= floor, f"{name} test accuracy {acc_test:.4f} < "
                             f"{floor:.4f} (JAX reference "
                             f"{JAX_TABLE1_TEST_ACC[name]} less {ACC_SLACK})")
    return tr, got


def table1_single_steps(torch, name, tr, data):
    """Kernel backend against plain from one state: the noisy unsupervised
    step (the same noise injected) and the readout step on a whole batch of
    64, and the eval step over the dataset's padded tail, every state
    array within 1e-4 and the served probabilities within 1e-4 with equal
    predictions.  The fitted state in layout (a); for the -struct presets
    also fresh states in layouts (b) and (c)."""
    import dataclasses
    from repro_torch.configs.bcpnn_models import BCPNN_MODELS
    from repro_torch.core import Trainer
    from repro_torch.core.network import (infer, supervised_readout_step,
                                          train_projection_step)
    cfg, dataset, _ = BCPNN_MODELS[name]
    xtr, ytr, _, _ = data[dataset]
    dev, b = "cuda", TABLE1_BATCH
    tail = len(xtr) % b
    x = torch.from_numpy(xtr[:b]).to(dev)
    y = torch.from_numpy(ytr[:b]).to(dev)
    xt = torch.zeros_like(x)
    xt[:tail] = x[:tail]
    valid = (torch.arange(b, device=dev) < tail).to(torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    layouts = [("a", tr.spec, tr.state)]
    if name in TABLE1_REWIRES:
        for v in ("b", "c"):
            fresh = Trainer(dataclasses.replace(cfg, **STRUCT_VARIANTS[v]),
                            seed=0, device=dev)
            layouts.append((v, fresh.spec, fresh.state))
    for v, spec, state in layouts:
        plain = spec.with_backend("torch")
        noise = torch.randn((b, spec.projs[0].post.N), generator=gen,
                            device=dev)
        d_unsup = state_diff(
            train_projection_step(state, spec, x, 0, noise=noise),
            train_projection_step(state, plain, x, 0, noise=noise))
        d_read = state_diff(supervised_readout_step(state, spec, x, y),
                            supervised_readout_step(state, plain, x, y))
        pk, qk = infer(state, spec, xt, valid)
        pp, qp = infer(state, plain, xt, valid)
        d_eval = (pk - pp).abs().max().item()
        same = torch.equal(qk, qp)
        print(f"[phase14] {name} ({v}{', fitted' if v == 'a' else ', fresh'}"
              f") kernel vs plain: noisy unsupervised step {d_unsup:.3e}, "
              f"readout step {d_read:.3e} (state max abs diff), eval step "
              f"over the {tail}-row tail {d_eval:.3e} (probabilities), "
              f"predictions {'equal' if same else 'DIFFER'}", flush=True)
        check(max(d_unsup, d_read, d_eval) <= 1e-4 and same,
              f"{name} ({v}): kernel and plain single steps differ "
              f"({d_unsup:.3e}, {d_read:.3e}, {d_eval:.3e}, predictions "
              f"equal: {same})")


def table1_int8_oracle(torch, name, tr, data):
    """The fitted state's int8 hidden forward (``quant_fwd``, or the
    patchy one for -struct) on 64 test rows against the exact integer
    accumulators: ``torch._int_mm`` of the Q0.7 codes and the weight codes
    in int32 (no sum can overflow: |acc| <= Ni * 127**2 < 2**31), widened
    to int64 (and on 8 rows of the first post-HC equal to numpy's int64
    product), then the plain epilogue; rates within QUANT_TOL.  (Not an
    fp32 product, which rounds sums past 2**24.)"""
    from repro_torch.configs.bcpnn_models import BCPNN_MODELS
    from repro_torch.core.bcpnn_layer import packed_forward
    from repro_torch.core.compact import gather_dense, unit_indices
    from repro_torch.core.network import pack_state
    from repro_torch.kernels import quantize_acts, ref
    _, dataset, _ = BCPNN_MODELS[name]
    spec = tr.spec.with_infer_dtype("int8")
    ps = spec.projs[0]
    pack = pack_state(tr.state, spec).projs[0]
    x = torch.from_numpy(data[dataset][2][:TABLE1_BATCH]).cuda()
    got = packed_forward(pack, ps, x)
    xq = quantize_acts(x).to(torch.int8)
    hj, mj = ps.post.H, ps.post.M
    if pack.table is None:
        acc = torch._int_mm(xq, pack.w).to(torch.int64)
        acc = acc.view(len(x), hj, mj)
    else:  # each post-HC's live rows of x and of the codes
        ui = unit_indices(pack.table, ps.pre.M, sentinel=x.shape[1])
        w_c = gather_dense(pack.w, ui, hj, mj)
        acc = torch.stack([torch._int_mm(xq[:, ui[j].long()].contiguous(),
                                         w_c[j].contiguous())
                           for j in range(hj)], 1).to(torch.int64)
    # numpy's int64 product on 8 rows of the first post-HC's live inputs
    live = (np.arange(x.shape[1]) if pack.table is None
            else ui[0].long().cpu().numpy())
    x64 = xq[:8].cpu().numpy().astype(np.int64)[:, live]
    w64 = pack.w.cpu().numpy().astype(np.int64)[live, :mj]
    check(np.array_equal(acc[:8, 0].cpu().numpy(), x64 @ w64),
          f"{name}: torch._int_mm's accumulators differ from numpy's int64")
    want = ref._quant_rates(acc.to(torch.float64), pack.scale, pack.b, hj,
                            mj, ps.gain)
    err = (got - want).abs().max().item()
    print(f"[phase14] {name} int8 hidden forward (Ni {ps.pre.N}) on 64 "
          f"test rows against the exact integer accumulators (largest "
          f"|acc| {acc.abs().max().item()}): max abs err {err:.3e}",
          flush=True)
    check(err <= QUANT_TOL, f"{name}: int8 forward {err:.3e} from the "
                            f"integer oracle")


def table1_no_sync(torch, name, data):
    """The epoch programs' captured steps of a fresh state, captured at
    their first batch, then replayed with any implicit device
    synchronisation an error: TABLE1_NO_SYNC_STEPS unsupervised steps
    (across one rewire of Model 2-struct, two of Model 3-struct), two
    readout steps and two eval batches; then int8 ``pack_state`` and three
    ``infer_packed`` calls the same way."""
    from repro_torch.configs.bcpnn_models import BCPNN_MODELS
    from repro_torch.core import Trainer
    from repro_torch.core.network import infer_packed, pack_state
    cfg, dataset, _ = BCPNN_MODELS[name]
    xtr, ytr, _, _ = data[dataset]
    b, n = TABLE1_BATCH, TABLE1_NO_SYNC_STEPS
    fresh = Trainer(cfg, seed=1, device="cuda")
    rows = np.arange(b * n) % len(xtr)  # breast has 546 rows: they repeat
    xs = torch.from_numpy(xtr[rows]).cuda().view(n, b, -1)
    ys = torch.from_numpy(ytr[rows]).cuda().view(n, b)
    valid = torch.ones((2, b), device="cuda")
    unsup, sup, ev = fresh._unsup_fn(0, False), fresh._sup_fn(False), \
        fresh._eval_fn()
    fresh.state = unsup(fresh.state, xs[:1])
    fresh.state = sup(fresh.state, xs[:1], ys[:1])
    ev(fresh.state, xs[:1], ys[:1], valid[:1])
    mask = fresh.state.projs[0].mask.clone()
    version = fresh.state.projs[0].mask._version
    spec8 = fresh.spec.with_infer_dtype("int8")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fresh.state = unsup(fresh.state, xs[1:])
        fresh.state = sup(fresh.state, xs[:2], ys[:2])
        acc = ev(fresh.state, xs[:2], ys[:2], valid)
        params = pack_state(fresh.state, spec8)
        for _ in range(3):
            infer_packed(params, spec8, xs[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    proj = fresh.state.projs[0]
    check(proj.traces.t_host == n == int(proj.traces.t.item()),
          f"{name}: clock mirror {proj.traces.t_host} after {n} steps")
    check(0.0 <= float(acc) <= 1.0, f"{name}: eval replay gave {acc}")
    rewires = proj.mask._version - version
    every = cfg.struct_every
    want = n // every if every else 0
    check(rewires == want, f"{name}: {rewires} rewires in {n} replayed "
                           f"steps, predicted {want}")
    return rewires, int((proj.mask != mask).sum().item()) // 2


def table1_step_fns(torch, name, tr, data):
    """Phase 4's rows of a fitted preset: its unsupervised step, readout
    step and eval batch at batch 64 as the epoch programs run them."""
    from repro_torch.configs.bcpnn_models import BCPNN_MODELS
    _, dataset, _ = BCPNN_MODELS[name]
    xtr, ytr, _, _ = data[dataset]
    x = torch.from_numpy(xtr[:TABLE1_BATCH]).cuda()
    y = torch.from_numpy(ytr[:TABLE1_BATCH]).cuda()
    return {f"{name} graphed {k}": fn for k, fn in
            graphed_steps(torch, tr.state, tr.spec, x, y).items()}


def phase14(torch):
    """Table-1 Models 2 and 3 and their -struct presets (``[phase14]``
    lines).  Returns the launches by run (the kernels line's ``runs``) and
    phase 4's step functions."""
    from repro_torch.configs.bcpnn_models import BCPNN_MODELS
    t = time.perf_counter()
    data = table1_data()
    print(f"[phase14] data: " + ", ".join(
        f"{k} {v[0].shape} + {v[2].shape}" for k, v in data.items())
        + f" in {time.perf_counter() - t:.2f} s", flush=True)
    runs, steps = {}, {}
    for name in TABLE1_PRESETS:
        tr, launches = table1_fit(torch, name, data)
        # the preset's key in the kernels line's "runs": model2_struct, ...
        tag = name.split("-")[0] + ("_struct" if name in TABLE1_REWIRES
                                    else "")
        runs[tag] = launches
        table1_single_steps(torch, name, tr, data)
        table1_int8_oracle(torch, name, tr, data)
        dataset = BCPNN_MODELS[name][1]
        fwd = "patchy_forward" if name in TABLE1_REWIRES else "bcpnn_fwd"
        q = "quant_patchy_forward" if name in TABLE1_REWIRES else "quant_fwd"
        runs.update(phase6_accuracy(
            torch, {tag: tr}, *data[dataset][2:],
            batch=TABLE1_EVAL_BATCH[dataset],
            kernels={tag: {"int8": q, "bf16": fwd}}, tag="[phase14]"))
        rewires, moved = table1_no_sync(torch, name, data)
        print(f"[phase14] {name}: {TABLE1_NO_SYNC_STEPS - 1} replayed "
              f"unsupervised steps ({rewires} rewires, {moved} pre-HCs "
              f"moved), two readout steps, two eval batches, int8 "
              f"pack_state and 3 infer_packed ran with no device "
              f"synchronisation", flush=True)
        if name in ("model2-pneumonia", "model3-breast"):
            steps.update(table1_step_fns(torch, name, tr, data))
    print(f"[phase14] done in {time.perf_counter() - t:.1f} s", flush=True)
    return runs, steps


EXAMPLES = (("repro_torch.examples.medical", "[medical]"),
            ("repro_torch.examples.quickstart", "[quickstart]"),
            ("repro_torch.examples.structural_plasticity", "[struct]"))


def examples_start():
    """Phase 14's last check, started before phase 7 to run beside its
    pytest process: the three examples on the card at their defaults, each
    in a process of its own, their logs kept."""
    return [start_module([module, "--device", "cuda"],
                         f"{module.rsplit('.', 1)[1]}.log")
            for module, _ in EXAMPLES]


def examples_finish(started):
    for (proc, log, t), (module, prefix) in zip(started, EXAMPLES):
        rc = proc.wait(timeout=600)
        lines = log.read_text().strip().splitlines()
        for line in lines:
            if line.startswith(prefix):
                print(f"[phase14] {line}", flush=True)
        print(f"[phase14] {module}: rc {rc} in {time.perf_counter() - t:.1f}"
              f" s, beside phase 7 (log {log.relative_to(ROOT)})",
              flush=True)
        check(rc == 0, f"{module} failed: {lines[-1:] or ['(no output)']}")


# -------------------------------------------------------------- phase 15 --

# The dry run (``repro_torch.launch.dryrun``) of phase 12's step (one rank)
# and of phase 13's (data 2, model 2) layout, at their batch of 8 x 256, and
# one production cell on (16, 16); each in a process of its own with no
# card visible (fake tensors on the CPU), beside phase 7.
P15_CELLS = (("1x1", ["--mesh-shape", "1x1", "--batch", str(TRAIN_BATCH),
                      "--seq", str(TRAIN_SEQ)]),
             ("2x2", ["--mesh-shape", "x".join(map(str, P13_MESH)),
                      "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]),
             ("16x16", []))
# The dry run's peak against phase 12's measured peak over what it held.
P15_PEAK_REL = 0.20


def phase15_start():
    """Phase 15's processes: ``python -m repro_torch.launch.dryrun --arch
    qwen1.5-0.5b --shape train_4k`` for each of ``P15_CELLS``, with
    ``CUDA_VISIBLE_DEVICES=""`` (they hold nothing on the card), records
    and logs under ``chiprun_out/dryrun_phase15/``."""
    out = ROOT / "chiprun_out" / "dryrun_phase15"
    out.mkdir(parents=True, exist_ok=True)
    started = []
    for name, extra in P15_CELLS:
        log = out / f"{name}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 "qwen1.5-0.5b", "--shape", "train_4k", "--out", str(out),
                 *extra], cwd=ROOT,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                     "CUDA_VISIBLE_DEVICES": ""},
                stdout=f, stderr=subprocess.STDOUT)
        started.append((proc, log, time.perf_counter()))
    return started


def _p15_record(name):
    """The dry-run record of ``P15_CELLS``' cell ``name``."""
    out = ROOT / "chiprun_out" / "dryrun_phase15"
    tail = "" if name == "16x16" else f"_b{TRAIN_BATCH}_s{TRAIN_SEQ}"
    return json.loads((out / f"qwen1.5-0.5b_train_4k_{name}{tail}.json")
                      .read_text())


def phase15_finish(started, held_peak, busy_s, ranks, smi):
    """Phase 15's checks: every process exits 0 and its cell is ``ok``;
    the one-rank estimate's peak within P15_PEAK_REL of phase 12's
    measured peak over what it held (``held_peak``); the one-rank
    record's larger of its compute and memory terms at most phase 12's
    profiled device-busy seconds a step (``busy_s``); on (2, 2) the bytes
    of parameters and of the moments a rank holds equal phase 13's ranks'
    (``ranks``) exactly, and the estimate's peak beside each rank's
    measured peak (a ratio, reported: rank 0 also holds the one-rank
    reference, and every rank serves after training); the (16, 16) cell's
    record."""
    recs = {}
    for (proc, log, t), (name, _) in zip(started, P15_CELLS):
        rc = proc.wait(timeout=600)
        lines = log.read_text().strip().splitlines()
        for line in lines:
            if line.startswith("[dryrun]"):
                print(f"[phase15] {line}", flush=True)
        print(f"[phase15] the {name} dry run: rc {rc} in "
              f"{time.perf_counter() - t:.1f} s, beside phase 7 (log "
              f"{log.relative_to(ROOT)})", flush=True)
        check(rc == 0, f"phase 15: the {name} dry run failed: "
                       f"{lines[-1:] or ['(no output)']}")
        recs[name] = _p15_record(name)
        check(recs[name]["status"] == "ok",
              f"phase 15: the {name} cell is {recs[name]['status']}")
    one, split, pod = recs["1x1"], recs["2x2"], recs["16x16"]
    est = one["memory"]["peak_memory_in_bytes"]
    rel = abs(est - held_peak) / held_peak
    print(f"[phase15] qwen1.5-0.5b train step, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, one rank: the dry run's peak {est / 2**30:.3f} GiB "
          f"(arguments {one['memory']['argument_size_in_bytes'] / 2**30:.3f}"
          f" GiB; fake CPU tensors, torch {one['torch']}, "
          f"traced in {one['trace_s']} s) against phase 12's measured peak "
          f"over what it held, {held_peak / 2**30:.3f} GiB: ratio "
          f"{est / held_peak:.4f} (limit {P15_PEAK_REL} either way; {smi})",
          flush=True)
    check(rel <= P15_PEAK_REL, f"phase 15: the dry run's peak {est} is "
                               f"{rel:.3f} from phase 12's {held_peak}")
    for name, rec in (("one rank", one), ("(16, 16)", pod)):
        rf = rec["roofline"]
        print(f"[phase15] {name}: the dry run's least time a step on the "
              f"card's peaks: compute {rf['compute_s'] * 1e3:.3f} ms "
              f"({', '.join(f'{k} {v:.4e}' for k, v in rf['flops_by_dtype'].items())}"
              f" FLOPs), memory {rf['memory_s'] * 1e3:.3f} ms "
              f"({rf['bytes']:.4e} B), collectives "
              f"{rf['collective_s'] * 1e3:.3f} ms ({rf['coll_bytes']:.4e} "
              f"B); bottleneck {rf['bottleneck']}", flush=True)
    rf = one["roofline"]
    least = max(rf["compute_s"], rf["memory_s"])
    print(f"[phase15] one rank: the larger of compute and memory, "
          f"{least * 1e3:.3f} ms, against phase 12's profiled device-busy "
          f"time a step at the same batch, {busy_s * 1e3:.3f} ms: ratio "
          f"{least / busy_s:.4f} ({smi})", flush=True)
    check(least <= busy_s, f"phase 15: the dry run's least time a step "
                           f"{least:.6f} s exceeds the card's busy time "
                           f"{busy_s:.6f} s (a count is wrong)")
    args = split["arguments"]
    moments = args["mu"] + args["nu"]
    speak = split["memory"]["peak_memory_in_bytes"]
    print(f"[phase15] the same step on (data {P13_MESH[0]}, model "
          f"{P13_MESH[1]}): the dry run gives a rank parameters "
          f"{args['params']} B, moments {moments} B; phase 13's ranks hold "
          + "; ".join(f"rank {i}: {q['bytes']['params'][0]} B, "
                      f"{q['bytes']['moments'][0]} B" for i, q in
                      enumerate(ranks))
          + f"; the dry run's peak {speak / 2**30:.3f} GiB against each "
          f"rank's measured peak: "
          + ", ".join(f"{speak / q['peak']:.3f}" for q in ranks)
          + f" (rank 0 also holds the one-rank reference; every rank also "
          f"serves after training)", flush=True)
    check(all(q["bytes"]["params"][0] == args["params"]
              and q["bytes"]["moments"][0] == moments for q in ranks),
          "phase 15: the dry run's bytes a rank holds on (2, 2) differ "
          "from phase 13's ranks'")
    mem, roof = pod["memory"], pod["roofline"]
    print(f"[phase15] the production cell qwen1.5-0.5b train_4k on (16, "
          f"16), torch {pod['torch']}: ok in {pod['trace_s']} s; a rank holds "
          f"{mem['argument_size_in_bytes'] / 2**30:.4f} GiB, peak "
          f"{mem['peak_memory_in_bytes'] / 2**30:.3f} GiB (fits one 80 GB "
          f"rank: {pod['fits_80GB']}); {roof['flops']:.4e} FLOPs a rank, "
          f"useful ratio {roof['useful_ratio']:.3f}, collectives "
          f"{roof['coll_bytes']:.4e} B {json.dumps(roof['coll_counts'])}; "
          f"lacks {', '.join(pod['lacks'])}", flush=True)


def phase7():
    """The ``gpu`` tests in their own pytest process, the log written under
    a name no other run takes; a failing test fails the run."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = out / time.strftime("gpu_tests_%Y%m%dT%H%M%SZ.log", time.gmtime())
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-m", "gpu", "tests/test_torch_cuda.py"], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, stdout=f,
            stderr=subprocess.STDOUT, timeout=600).returncode
    tail = log.read_text().strip().splitlines()[-1:] or ["(no output)"]
    check(rc == 0, f"gpu tests failed (rc {rc}, log {log.relative_to(ROOT)}):"
                   f" {tail[0]}")
    print(f"[phase7] gpu tests: {tail[0]} (log {log.relative_to(ROOT)})",
          flush=True)


# --------------------------------------------------------------- phase 4 --

# Phase 4 times a step's untraced wall in this many windows of 20 steps
# and keeps the median: the host is shared, and one window's wall has
# parted from another's by up to 2x.
WALL_WINDOWS = 5


def phase4(torch, tr, tr_b, tr_c, xte, yte, more):
    """Time, then trace, 20 steps of each main-path step type on the
    fitted dense Model-1 state, of (b)'s unsupervised step (one
    ``patchy_update`` launch each) and eval batch (one ``patchy_forward``),
    and of (c)'s unsupervised step and eval batch on their fitted Model
    1-struct states (results are dropped; only
    the state's generator advances); then, for the dense and (c) states,
    the eval batch in int8 and bf16 (``infer``, which packs the state on
    every call) and the served batch (``infer_packed`` on a pack made
    once), and (b)'s int8 served batch (one ``quant_patchy_forward``).
    Last, for Model 1, (b) and (c): the eval program's step run eagerly
    (``eager_eval_step``), then the unsupervised step, readout step and
    eval batch as the epoch programs run them (``graphed_steps``, on
    copies of the fitted states), and the rows of ``more``: phase 8's
    served batches and phase 14's Model-2 and Model-3 steps.  The trace
    slows the host, so the idle share divides the traced device-busy time
    by the untraced wall time (the median of ``WALL_WINDOWS`` windows)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.network import (infer, infer_packed, pack_state,
                                          supervised_readout_step,
                                          train_projection_step)
    dev = tr.device
    spec, state = tr.spec, tr.state
    spec_b, state_b = tr_b.spec, tr_b.state
    spec_c, state_c = tr_c.spec, tr_c.state
    x = torch.from_numpy(xte[:128]).to(dev)
    y = torch.from_numpy(yte[:128]).to(dev)
    steps = {
        "unsup_step": lambda: train_projection_step(state, spec, x, 0),
        "readout_step": lambda: supervised_readout_step(state, spec, x, y),
        "eval_batch": lambda: infer(state, spec, x),
        "(b) unsup_step": lambda: train_projection_step(state_b, spec_b, x,
                                                        0),
        "(b) eval_batch": lambda: infer(state_b, spec_b, x),
        "(c) unsup_step": lambda: train_projection_step(state_c, spec_c, x,
                                                        0),
        "(c) eval_batch": lambda: infer(state_c, spec_c, x),
    }
    for label, st, sp in (("", state, spec), ("(c) ", state_c, spec_c)):
        for dtype in ("int8", "bf16"):
            sp_d = sp.with_infer_dtype(dtype)
            params = pack_state(st, sp_d)
            steps[f"{label}{dtype} eval_batch"] = \
                lambda st=st, sp_d=sp_d: infer(st, sp_d, x)
            steps[f"{label}{dtype} served_batch"] = \
                lambda params=params, sp_d=sp_d: infer_packed(params, sp_d, x)
    # (b)'s int8 served batch: one quant_patchy_forward launch
    spec_b8 = spec_b.with_infer_dtype("int8")
    params_b8 = pack_state(state_b, spec_b8)
    steps["(b) int8 served_batch"] = lambda: infer_packed(params_b8, spec_b8,
                                                          x)
    for label, st, sp in (("", state, spec), ("(b) ", state_b, spec_b),
                          ("(c) ", state_c, spec_c)):
        steps[f"{label}eval_step"] = eager_eval_step(torch, st, sp, x, y)
        for name, fn in graphed_steps(torch, st, sp, x, y).items():
            steps[f"{label}graphed {name}"] = fn
    # phase 8's served batches at bucket 64; phase 14's Model-2 and Model-3
    # steps as the epoch programs run them
    steps.update(more)
    n = 20
    for name, fn in steps.items():
        for _ in range(3):
            fn()
        walls = []
        for _ in range(WALL_WINDOWS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e6 / n)
        wall_us = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            traced_us = (time.perf_counter() - t) * 1e6 / n
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels) / n
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[phase4] {name}: wall {wall_us:.1f} us/step (traced "
              f"{traced_us:.1f}), device busy {busy_us:.1f} us/step, idle "
              f"share {max(0.0, 1 - busy_us / wall_us):.3f}, "
              f"{sum(e.count for e in kernels) / n:.1f} kernels/step; top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / n:.1f}"
                          f" us" for e in top), flush=True)


def clone_state(state):
    """A copy of a state with every tensor and the generator its own."""
    import dataclasses
    from repro_torch.core.graphs import scratch_clone
    st = scratch_clone(state)
    return dataclasses.replace(st, projs=tuple(
        dataclasses.replace(p, mask=p.mask.clone(),
                            table=None if p.table is None else p.table.clone())
        for p in st.projs))


def eager_eval_step(torch, state, spec, x, y):
    """The eval program's step run eagerly: ``infer`` under a validity
    mask, its correct and genuine rows added into two accumulators (more
    work than the ``eval_batch`` row's bare ``infer``)."""
    from repro_torch.core.network import infer
    valid = torch.ones(x.shape[0], device=x.device)
    correct = torch.zeros((), device=x.device)
    total = torch.zeros_like(correct)

    def step():
        _, pred = infer(state, spec, x, valid=valid)
        correct.add_(((pred == y).to(torch.float32) * valid).sum())
        total.add_(valid.sum())

    return step


def graphed_steps(torch, state, spec, x, y):
    """One step each of the unsupervised step, the readout step and the
    eval batch as the epoch programs run them: the input copy and the
    replay of the captured step, then the host's share (the clock mirror's
    tick and the rewire check).  They step a copy of ``state``; each is
    captured here, by its first call."""
    from repro_torch.core import trainer as T
    from repro_torch.core.network import rewire_layer
    box = [clone_state(state)]
    unsup = T._projection_program(spec, 0, frozen=False, noise=False)
    readout = T._readout_program(spec)
    ev = T._EvalProgram(spec)
    valid = torch.ones(x.shape[0], device=x.device)

    def unsup_step():
        unsup(box[0], x)
        box[0] = rewire_layer(T._tick(box[0], 0), spec, 0, donate=True)

    def readout_step():
        readout(box[0], x, y)
        box[0] = T._tick(box[0], None)

    ev(box[0], x[None], y[None], valid[None])  # allocates and captures
    return {"unsup_step": unsup_step, "readout_step": readout_step,
            "eval_batch": lambda: ev.steps(box[0], x, y, valid)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on "
              "the card only", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi gave nothing: {smi.stderr.strip()}", flush=True)
    print(f"[phase0] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}",
          flush=True)
    from repro_torch.kernels import _build
    t = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[phase0] kernels built/loaded from {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are enabled; the port's fp32 contract needs them off")

    rows = phase1(torch)
    tr, data, launches = phase2(torch)
    xtr, ytr, xte, yte = data
    phase3(torch, tr, xte, yte)
    fitted, struct_launches = phase5(torch, xtr, ytr, xte, yte)
    serve_launches = phase6(torch, tr, fitted, xte, yte)
    stream_launches, served = phase8(torch, tr, fitted, data)
    stream_launches.update(phase9(torch, tr, fitted, data))
    phase10(torch, data)
    table1_runs, table1_steps = phase14(torch)
    phase4(torch, tr, fitted["b"], fitted["c"], xte, yte,
           {**served, **table1_steps})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    head_launches = phase11(torch)
    held_peak, busy_s = phase12(torch, smi)
    ranks = phase13(torch, smi)
    started = [launcher_start()]
    resume = None
    try:
        resume = phase12_resume()
        started += phase11_start()
        started += examples_start()
        started += phase15_start()
        phase7()
        launcher_finish(started[0])
        phase11_finish(started[1:3])
        examples_finish(started[3:6])
        phase15_finish(started[6:], held_peak, busy_s, ranks, smi)
        phase12_resume_finish(resume)
    finally:
        for proc, _, _ in started:  # nothing left running, whatever failed
            proc.kill()
            proc.wait()
        if resume is not None:
            for proc in list(resume[1]["procs"]):
                proc.kill()
                proc.wait()
            resume[0].join(timeout=60)

    # "launches": the dense kernels' from the Model-1 fit of phase 2, the
    # patchy kernels' from the struct fit that runs them (compact: (c);
    # patchy: (b)), the int8 kernels' from phase 6's int8 evaluation of
    # the state that runs them; every run's counts are under "runs".
    runs = {"model1": launches, **{f"struct_{v}": c
                                   for v, c in struct_launches.items()},
            **serve_launches, **stream_launches, **head_launches,
            **table1_runs}
    main_run = {"patchy_forward": "struct_b", "patchy_update": "struct_b",
                "compact_forward": "struct_c", "compact_update": "struct_c",
                "quant_fwd": "model1_int8",
                "quant_patchy_forward": "struct_b_int8",
                "quant_compact_forward": "struct_c_int8"}
    kernels = []
    for name, (source, replaces, label) in SOURCES.items():
        row = rows[name][label]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": runs[main_run.get(name, "model1")][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shapes": rows[name],
            "runs": {run: c[name] for run, c in runs.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
