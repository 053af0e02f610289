#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

From the root of a checkout:  python3 chip_smoke.py

1. builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel against its plain torch version at the shapes of the
   main paths: CTR and MAC bit for bit on one page-batch gather (all B*P
   pages, per-page keys), one slot seal with explicit rows, every weight
   leaf (granite's unembed has an odd width; its MAC chunks are 2 words)
   and the flat tag_root of one slot; sealed attention within two bf16
   ulps (``ref.OUT_RTOL``, ``ref.OUT_ATOL``) with exact ``bad`` counts at
   B 8, T 1024 (t_valid 1, 700, 1024) and T 1000, verify off and on, a
   flipped ciphertext bit inside and past t_valid, and two controls that
   the limit must reject (the rows past t_valid 700 read to the kernel
   tile's end; the last valid row dropped); the sealed matmul within two
   bf16 ulps plus K 2^-24 max|A| max|B| (``ref.c_excess``) with an exact
   ``bad`` grid at 256^3, at (512, 256, 512) with a flipped A bit and a
   flipped B bit, and at granite's two MLP products of one 8192-token
   microbatch (B the sealed w_gate and w_down of layer 0), with two
   controls the limit must reject (the last k-step skipped, B's keystream
   one row off), then its entry point ``ops.matmul`` over both products —
   and times kernel, plain version and, for attention, SDPA over the
   decrypted cache, for the matmul torch.matmul over the plaintext; and
   RWKV-6's and Mamba-2's scan kernels, forward and backward, at one
   layer of rwkv6-3b (B 1, S 4096, H 40, hd 64) and of zamba2-1.2b (H 64,
   p 64, N 64) against the plain per-token loops within the limits of
   ``kernels/*_scan/ref.py``, timed in CUDA graphs beside their bounds;
   each scan's kernels also twice on the same inputs (bit for bit) and on
   runs of decays of exactly 0 and 1 (RWKV-6's also on strong decays),
   with each call's kernels and grids;
3. serves granite-3-2b at its full published width and depth (40 layers,
   bf16, random weights from a seeded torch.Generator) through the sealed
   paged engine: two tenant channels, weights sealed under the provider
   channel, four requests with prompts of 9, 23, 40 and 64 tokens and 24
   new tokens each, so chunked prefill, decode across page boundaries and
   page closes all run;
4. checks the result: no lane poisoned, every step launched both kernels,
   the sealed-byte counters add up, and the smoke config served on the
   card gives the same tokens as on the CPU;
5. tampers: one flipped bit in a page of each of tenant A's requests
   poisons exactly A's lanes; one flipped bit of a weight leaf poisons
   every lane;
6. runs the fixed-slot ``ServeEngine`` (8 prompts of 1000 tokens, 16 new
   tokens, a 1024-slot sealed cache) unfused, then with the sealed
   flash-decode kernel: finite logits, equal first tokens, first decode
   logits within 0.2, 40 kernel launches per fused decode step, a flipped
   weight bit poisons every lane; per-layer times of the kernel against
   CTR unseal + plain attention;
7. serves through ``SecureGateway``: a 32-token prefix matched by two
   requests, four low-priority requests and a priority-5 one that
   preempts (swap out and in), an audit chain that verifies, and a
   flipped page bit in each of one tenant's requests poisoning only those;
8. trains granite-3-2b at full width and depth: the state (params, Adam
   moments) sealed by ``seal_state``, three steps of two 4096-token
   microbatches through ``make_train_step``, resealed in place; finite
   losses, seal_ok, CTR and MAC launched every step, the peak memory and
   a profiled step; a flipped bit in a sealed mu leaf poisons the state;
   then the smoke config trained for 4 steps through ``Supervisor`` (a
   failure at step 2, checkpoint, restart, lane refreshes) on the card and
   on the CPU: losses within 1e-4 relative, the same events;
9. serves qwen3-4b, minitron-8b, internvl2-2b (VLM), rwkv6-3b (RWKV-6),
   zamba2-1.2b (Mamba-2 hybrid), moonshot-v1-16b-a3b (MoE, 64 experts
   top-6) and seamless-m4t-large-v2 (encoder-decoder) in turn at their full
   published width through the fixed-slot ``ServeEngine`` (the families
   phase), at full depth but moonshot's (24 of 48 layers: its whole-tree
   unseal holds ciphertext and plaintext at once), random weights from a
   seeded torch.Generator, 4 lanes of 128-token prompts (internvl2-2b: 256
   patch embeddings before them; seamless: 128 frame embeddings), 8 new
   tokens,
   first with security off, then sealed by the provider: every distinct
   (leaf shape, dtype, chunk width) of the sealed tree through the CTR and
   MAC kernels against their plain versions bit for bit, with its MAC path
   (small, wide or general), ``graph_ms`` and bound, summed over one
   decode step's unseal; the sealed tokens equal the insecure ones, every
   sealed decode step launches both kernels, a flipped word of a sealed
   weight leaf poisons every lane in one decode; for qwen3-4b the fused
   decode too, and the sealed-attention kernel at B 4, K 8, G 4, hd 128,
   T = max_len within two bf16 ulps; tok/s, prefill and decode ms, launches
   a step and peak memory beside the card's name and power limit;
   moonshot's stacked expert leaves (2.21 G words each) take the MAC
   kernel's row slabs and the CTR kernel past 2^31 words; then
   llama4-maverick-400b-a17b's SMOKE config (dense and MoE layers in
   pairs) served sealed on the card and on the CPU: the same tokens;
10. trains every family sealed (the train-families phase) through
   ``launch/steps.py`` (``make_cell``, ``make_train_step_fn``, in place,
   every block recomputed): moonshot-v1-16b-a3b at full width cut to 4 of
   its 48 layers (30.2 GB of sealed state), seamless-m4t-large-v2 (20.3
   GB), rwkv6-3b (31.0 GB) and zamba2-1.2b (11.8 GB) at full size, three
   steps of one 4096-token sequence each (seamless: 4096 frame embeddings
   into its encoder), finite losses, seal_ok, CTR and MAC launched every
   step, the scan kernels one forward a layer call and one backward a
   layer (``scan_launches_per_step``), peak memory, one profiled
   step (busy, idle share, top three kernels), and a flipped bit in a
   sealed mu leaf that poisons the state; every SMOKE config (the ten
   ARCH_IDS, llama4 and llama3 with bf16 moments and accumulators) one
   sealed step on the card and on the CPU within the CPU tests' limits;
   then ``make_crosspod_grad_hook`` in a one-process NCCL group over
   moonshot's gradients of one step: quantize off returns them bit for
   bit, quantize on within half an int8 step, and one pod's seal of the
   payload through the CTR kernel timed in CUDA graphs against its bound;
   then rwkv6-3b and zamba2-1.2b at full size prefill one 32768-token
   prompt sealed through ``make_prefill_fn`` (prefill_32k with its batch
   cut to 1): time, peak memory, one scan forward a layer; and at 2048
   tokens their last-token logits against the plain loops' on the card
   within PREFILL_LOGIT_TOL, as published and in float32;
11. runs the parallel phase in two processes that share the card over
   gloo (``parallel_phase``): first which gloo operations take tensors on
   the card (two throwaway processes), one pipeline hop's seal through the
   CTR kernel in a CUDA graph against its bound, then in both processes
   moonshot-v1-16b-a3b at full width (4 of 48 layers, one 2048-token
   sequence) through the global dispatch and through ``moe_ep`` on a
   (data 1, model 2) mesh, each rank holding 32 experts: the loss and
   every gradient within the stated limits, and a control that drops
   x's model-group gradient sum outside them; granite-3-2b at full size
   as a two-stage sealed pipeline of 4 microbatches of 1 x 1024 tokens
   against the unpipelined mean: the loss and gradients within the
   limits, CTR launched in the step, a control that unseals the backward
   hop in the forward domain outside them; and granite's sealed parameters
   saved by ``checkpoint.save`` here and restored onto
   ``make_smoke_mesh(2)`` by ``elastic_restore``: every local ct and tags
   block equal to the slice of the same leaves sealed again, bit for bit;
   then granite's sealed train state sharded over that mesh
   (``train_state_shardings``; each rank seals its own blocks against the
   leaves' global CTR counters, the CTR kernel's column offset for the
   leaves split on their last axis) through ``make_train_step_fn`` in
   place, 3 steps of 2 microbatches of 1 x 1024 tokens: the first step's
   loss within 1e-3 of one process's step on the same batch (taken here
   before the ranks start), seal_ok, CTR and MAC launched every step,
   each rank's peak and sealed bytes held, and a flipped bit in one rank's
   block of a column-sharded leaf that poisons the state on both ranks;
   the kernel checks above hold the CTR kernel's column offset (col0 4096
   and col0 3) against its plain version, and the MAC of a block's own
   chunks, repositioned, against the whole rows' tags; then granite's
   sealed parameters sharded over that mesh (``params_shardings``, each
   rank sealing its own blocks) serve 4 prompts of 2048 tokens into a
   4096-slot sealed cache and 16 greedy decode steps through
   ``make_prefill_fn`` / ``make_decode_fn``: tokens equal to one
   process's serving of the same parameters and prompts on the card
   (taken after the ranks end), rank 0's cache block (the prompts'
   slots) unchanged by the decode steps and rank 1's changed, and a
   flipped bit in rank 1's block of a parameter leaf giving NaN logits on
   both ranks; and the dry run (``launch/dryrun.py``, a process of its
   own on the host, a fake group of 2 on the meta device) of the serving
   prefill, decode step and the sharded train step gives the gloo calls
   and bytes and the CTR and MAC launches the card counted in every call;
12. runs the examples phase (``examples_phase``): the four examples of
   ``examples/*_torch.py`` through their ``run`` at their own sizes —
   secure serving (sealed tokens equal the plaintext engine's), the
   quickstart (tamper detected, ``6/6 done, swaps out/in 2/2``), sealed
   training at ``--full100m`` (768 wide, 10 layers, vocab 32768) for 30
   steps through an injected failure (the loss falls, the state stays on
   the card), and the multipod example as two gloo processes (pods) on
   the card for 8 steps (equal sealed states after every step, the loss
   falls on both; gloo calls timed by ``_collective_clock``; one pod's
   int8 payload seal against its bound) — then the serve launcher with
   ``--trace`` and ``--audit`` and the three tools on its files
   (``verify_audit_torch`` exits 0, and 1 on a copy with one record
   edited; ``trace2perfetto_torch``; ``obs_dash_torch``);
13. prints the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

Each path's kernel launch counts are zeroed just before it runs and read
just after.  Any failed check raises and the script exits non-zero.
Without a CUDA device, or outside a checkout, it exits non-zero before
printing a result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks for the bound: HBM3 at 3.35 TB/s (data sheet), and 32-bit
# integer operations at 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
# (Hopper architecture white paper) = 16.7 T ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations in the kernels' arithmetic (counted from the source):
# a Threefry-2x32 block is 20 rounds of add/rotate/xor, 5 key injections of
# 2 adds, 2 initial adds and the 2 XORs with the data; a MAC word is two
# folds and the +1, a 64-bit product with two folds, and the 64-bit add.
CTR_OPS_PER_BLOCK = 20 * 3 + 5 * 2 + 2 + 2
MAC_OPS_PER_WORD = 20
# Of a Threefry block's 74, only the 20 rotates (SHF) and 22 XORs (LOP3)
# must issue on the ALU pipe; the 32 adds can issue as IMAD on the FMA pipe
# beside them (ptxas puts most there: the SASS mix below).  A MAC word's
# 64-bit product issues as IMAD.WIDE on the FMA pipe; its folds, +1 and
# 64-bit adds take 14 ALU-pipe instructions (LOP3, SHF, LEA, IADD3), read
# in the SASS of verify_chunks_kernel's four words a lane (mac_word_alu_ops
# prints 14.5: one of its 58 is the lane test).  So the least time of a
# block is 42 operations and of a word 14 at the 64 INT32 lanes; the bound
# uses those, and keeps the figure with all 74 and 20 on the ALU pipe
# beside it as bound_ms_74.
CTR_ALU_OPS_PER_BLOCK = 20 + 20 + 2
MAC_ALU_OPS_PER_WORD = 14
# float32 outside the tensor cores (data sheet), for the attention's dot
# products in the sealed-attention kernel
F32_FLOPS_PER_S = 67e12

# dense bf16 on the tensor cores (data sheet), for the sealed matmul
BF16_FLOPS_PER_S = 989e12

N_PAGES, PAGE, CHUNK_WORDS = 64, 16, 128
SLOTS, MAX_PAGES, PREFILL_CHUNK = 4, 8, 64
PROMPTS, MAX_NEW = (9, 23, 40, 64), 24
SEED = 0
# the fixed-slot phase: 8 lanes of 1000-token prompts, 16 new tokens each,
# in a 1024-slot cache (granite: 8 KV heads of 4 query heads, hd 64)
FIXED_B, FIXED_PROMPT, FIXED_NEW, FIXED_MAX_LEN = 8, 1000, 16, 1024
LOGIT_TOL = 0.2     # fused vs plain decode logits (the reference's own)
# the train phase: train_4k's sequence, cut from 16 sequences per
# microbatch and 256 a step to one and two (8192 tokens), three steps
TRAIN_ACCUM, TRAIN_STEPS = 2, 3
# the families phase: each configuration at full published width through
# the fixed-slot engine, 4 lanes of 128-token prompts (internvl2-2b: 256
# patch embeddings before them; seamless-m4t-large-v2: 128 frame
# embeddings for its encoder), 8 new tokens
FAMILY_ARCHS = ("qwen3-4b", "minitron-8b", "internvl2-2b", "rwkv6-3b",
                "zamba2-1.2b", "seamless-m4t-large-v2", "moonshot-v1-16b-a3b")
# depth cuts: a sealed decode step unseals the whole weight tree, so
# ciphertext and plaintext are held at once: moonshot at 24 layers is
# 2 x 29.6 GB, at its 48 it would be 2 x 58 GB, more than the 80 GB card
FAMILY_CUTS = {"moonshot-v1-16b-a3b": {"n_layers": 24}}
FAMILY_B, FAMILY_PROMPT, FAMILY_NEW = 4, 128, 8
# the train-families phase: each configuration at its full published width
# through launch/steps.py (make_cell, make_train_step_fn; every block
# recomputed), resealed in place, one train_4k sequence of 4096 tokens a
# step (global batch 256 -> 1), three steps, a profiled one, a tampered one
TRAIN_FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "seamless-m4t-large-v2",
                      "rwkv6-3b", "zamba2-1.2b")
# depth cut: the sealed state is 10 bytes a parameter (bf16 weights, f32
# mu and nu) and a step holds the plaintext weights and the f32 gradient
# sums beside it: moonshot at 4 of its 48 layers is 3.02 B parameters,
# 30.2 GB sealed; at 48 it would be 16 B, 160 GB
TRAIN_FAMILY_CUTS = {"moonshot-v1-16b-a3b": {"n_layers": 4}}
TRAIN_FAMILY_STEPS = 3
# RWKV-6's and Mamba-2's scan kernels against their plain versions at one
# layer of rwkv6-3b (B 1, H 40, hd 64) and of zamba2-1.2b (B 1, H 64, p 64,
# N 64) over one train_4k sequence, forward and backward, within the limits
# of kernels/*_scan/ref.py (outputs 1e-5 of their largest entry + 1e-6,
# gradients 1e-4 of theirs), timed in CUDA graphs
SCAN_SEQ = 4096
# the long prefill of the recurrent families: prefill_32k's 32768-token
# prompt with its batch cut from 32 to 1, sealed, through make_prefill_fn;
# at 2048 tokens its last-token logits against the plain per-token loops'
# on the card, as published (bfloat16) and in float32
LONG_PREFILL_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
LONG_PREFILL_LEN, LONG_PREFILL_CHECK = 32768, 2048
# the limits of that comparison, from tools/prefill_logit_spread.py on the
# H100 (seeds 0-3; PERF.md §6).  In float32 the kernels' sums, in another
# order than the loops', move the logits by at most 4.0e-5 (rwkv6-3b) and
# 1.7e-5 (zamba2-1.2b); a wrong scan (no u bonus, y read before the
# token's input, a decay applied a token late) by 3.0e-3 or more: 4e-4
# lies between.  In bfloat16 that rounding grows through the layers to
# 0.168 and 0.066, and rwkv6-3b's wrong scans read 0.166-0.297: there the
# limit, twice the largest sound reading, guards against gross faults only
PREFILL_LOGIT_TOL = {"bfloat16": {"rwkv6-3b": 0.35, "zamba2-1.2b": 0.15},
                     "float32": {"rwkv6-3b": 4e-4, "zamba2-1.2b": 4e-4}}
# the SMOKE configs: one sealed step of two microbatches of 2 x 16 tokens
# on the card and on the CPU; the cross-pod hook over moonshot's gradients
SMOKE_TRAIN = dict(seq=16, batch=2, accum=2)
CROSSPOD_ARCH = "moonshot-v1-16b-a3b"
SLAB_BYTES = 1 << 28   # rows of a leaf each plain-version call takes
# granite's MLP products for one such microbatch: (name, M, K, N)
MLP_PRODUCTS = (("w_gate", 8192, 2048, 8192), ("w_down", 8192, 8192, 2048))
# the parallel phase: two processes on the one card over gloo.  EP:
# moonshot at full width cut to 4 of 48 layers (as the train-families
# phase), one sequence of 2048 tokens (train_4k's 4096 halved: both
# processes hold the global dispatch's run at once), each model rank
# holding 32 of the 64 experts.  Pipeline: granite at full width and depth,
# 2 stages of 20 layers, 4 microbatches of 1 x 1024 tokens, sealed hops.
PAR_EP_ARCH, PAR_EP_CUTS, PAR_EP_SEQ = ("moonshot-v1-16b-a3b",
                                       {"n_layers": 4}, 2048)
PAR_PP_ARCH, PAR_PP_STAGES, PAR_PP_MICRO, PAR_PP_SEQ = "granite-3-2b", 2, 4, 1024
# limits set before the first run (bf16 at full width): the loss within
# this share of itself, each gradient leaf within this share of its
# largest entry; the controls must exceed the gradient limit
PAR_EP_LOSS_RTOL, PAR_EP_GRAD_RTOL = 1e-3, 2e-2
PAR_PP_LOSS_RTOL, PAR_PP_GRAD_RTOL = 1e-4, 1e-2
# the sharded sealed train step: granite at full width and depth on
# make_smoke_mesh(2) (data 1, model 2), each rank holding its blocks of the
# sealed state; two microbatches of 1 x 1024 tokens a step (train_4k's
# 256 x 4096 tokens cut to 2048), three steps, then one with a flipped
# ciphertext bit in one rank's block.  Its first step's loss is held
# against one process's step on the same batch and state within this
# limit (the reference test's), set before the first run
PAR_SH_MICRO, PAR_SH_SEQ, PAR_SH_STEPS = 2, 1024, 3
PAR_SH_LOSS_ATOL = 1e-3
PAR_SH_TAMPER_RANK, PAR_SH_TAMPER_LEAF = 1, ("layers", "mlp", "w_gate")
# the sharded sealed serving step: granite at full width and depth on
# make_smoke_mesh(2), its sealed parameters sharded by params_shardings and
# each rank sealing its own blocks; four prompts of 2048 tokens prefilled
# into a 4096-slot sealed cache (prefill_32k's 32 x 32768 and decode_32k's
# 128 x 32768 cut to 4 x 4096), then 16 greedy decode steps: rank 0 holds
# the prompts' slots of the cache, rank 1 the decode writes.  Its tokens
# are held against one process's serving of the same parameters and
# prompts on the card, and its collectives and launches against the dry
# run's count of the same cells (launch/dryrun.py)
PAR_SV_BATCH, PAR_SV_PROMPT, PAR_SV_SLOTS, PAR_SV_STEPS = 4, 2048, 4096, 16
PAR_SV_TAMPER_RANK = 1
PAR_KEY_BYTES = b"chip-smoke-elastic-restore"
PAR_TIMEOUT_S = 600
GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "send_recv")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_name(mangled: str) -> str:
    """"sealed_matmul_kernel<4,2>" from the mangled name of a kernel."""
    base = re.search(r"\d+([a-z_]+(?:kernel|split|combine))", mangled)
    args = re.findall(r"Li(\d+)E", mangled)
    return (base.group(1) if base else mangled) + (
        f"<{','.join(args)}>" if args else "")


def ptxas_report(log: str) -> dict:
    """Registers, shared memory and spills of each kernel in one source's
    nvcc -Xptxas -v output: {"kernel<template args>": "ptxas line; spill
    line"}."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = kernel_name(ln.split("'")[1])
        elif fn and "spill stores" in ln:
            out[fn] = ln.strip()
        elif fn and "Used" in ln and "registers" in ln:
            out[fn] = ln.split(":", 1)[1].strip() + "; " + out.get(fn, "")
    return out


def mac_word_alu_ops(funcs: dict) -> float:
    """ALU-pipe instructions per MAC word in sealed_matmul.cu's
    verify_chunks_kernel (``build.sass_opcodes`` of its SASS): each lane
    tags four words in straight-line code between its last load and its
    first shuffle, the final folds of its sum included."""
    from repro_torch.kernels import build

    ops = next(o for fn, o in funcs.items() if "verify_chunks_kernel" in fn)
    end = ops.index("SHFL")
    start = max(i for i in range(end) if ops[i] == "LDG") + 1
    return sum(op in build.ALU_OPCODES for op in ops[start:end]) / 4


def device_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` (CUDA events) after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_events(prof):
    """The profiler's device (kernel) rows.  A CPU operator's row repeats
    the device time of the kernels it launched, so only these rows add up
    to the time the device was busy."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def device_busy(fn, reps: int = 20) -> tuple[float, float]:
    """Device time of ``fn`` per call and kernel rows seen per call: its
    kernels' own times under torch.profiler over ``reps`` calls, after one
    warm-up call.  Unlike CUDA events around one call, it leaves out the
    host time between launches; the kernel count shows whether the
    profiler kept every launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    return (sum(e.self_device_time_total for e in events) / 1e3 / reps,
            sum(e.count for e in events) / reps)


def device_busy_ms(fn, reps: int = 20) -> float:
    return device_busy(fn, reps)[0]


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn`` per call from CUDA-event timing of a CUDA graph
    of ``reps`` calls, replayed five times: the kernels back to back with
    no host time between them and no profiler."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (5 * reps)


def bound_of(nbytes, ops):
    """(ms, what bounds it): bytes at the HBM rate or integer operations at
    the INT32 rate, whichever is slower."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_checks(sealed, provider_key):
    """Every kernel against its plain version at the main path's shapes.

    Returns {kernel: [workload dicts]}, each with mismatches, max_abs_err,
    ms (kernel, in a CUDA graph), event_ms (CUDA events around one call,
    host time included), plain_ms, bytes, ops, bound_ms and bound_by.
    """
    from repro_torch.core import cipher, mac, sealed as sealed_lib
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops, ref as ctr_ref
    from repro_torch.kernels.tree_mac import ops as mac_ops, ref as mac_ref
    from repro_torch.serve import kv_pager

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def bits(shape, dtype):
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                          device="cuda", dtype=torch.int64)
        return x.to(dtype)

    def compare(out, ref):
        diff = (out.to(torch.int64) - ref.to(torch.int64)).abs()
        return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0

    results = {"ctr_cipher": [], "tree_mac": []}

    def ctr_case(name, x, tkeys, rows=None, step_share=1, col0=0):
        out = ctr_ops.ctr_xor(x, tkeys, rows, col0)
        ref = ctr_ref.ctr_xor_ref(x, tkeys, rows, col0)
        mism, err = compare(out, ref)
        del out, ref
        ms = graph_ms(lambda: ctr_ops.ctr_xor(x, tkeys, rows, col0))
        event_ms = device_ms(lambda: ctr_ops.ctr_xor(x, tkeys, rows, col0))
        plain_ms = device_ms(lambda: ctr_ref.ctr_xor_ref(x, tkeys, rows,
                                                         col0), reps=1)
        n, r, e = x.shape
        epb = 8 // x.element_size()          # elements a Threefry block
        blocks = n * r * (-(-(col0 % epb + e) // epb))
        nbytes = 2 * x.numel() * x.element_size()
        b, by = bound_of(nbytes, blocks * CTR_ALU_OPS_PER_BLOCK)
        results["ctr_cipher"].append(dict(
            shape=name, dims=list(x.shape), col0=col0, mismatches=mism,
            max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
            bytes=nbytes, ops=blocks * CTR_OPS_PER_BLOCK,
            alu_ops=blocks * CTR_ALU_OPS_PER_BLOCK, bound_ms=b, bound_by=by,
            per_step=step_share))
        torch.cuda.empty_cache()

    def mac_case(name, x, keys, step_share=1):
        cw = keys.shape[1]
        out = mac_ops.mac_tags(x, keys)
        ref = mac_ref.mac_tags_ref(x, keys, cw)
        mism, err = compare(out, ref)
        del ref
        ms = graph_ms(lambda: mac_ops.mac_tags(x, keys))
        event_ms = device_ms(lambda: mac_ops.mac_tags(x, keys))
        plain_ms = device_ms(lambda: mac_ref.mac_tags_ref(x, keys, cw), reps=1)
        n, r, e = x.shape
        words = n * r * (-(-e * x.element_size() // 4))
        nbytes = x.numel() * x.element_size() + out.numel() * 4
        b, by = bound_of(nbytes, words * MAC_ALU_OPS_PER_WORD)
        results["tree_mac"].append(dict(
            shape=name, dims=list(x.shape), cw=cw, mismatches=mism,
            max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
            bytes=nbytes,
            ops=words * MAC_OPS_PER_WORD,
            alu_ops=words * MAC_ALU_OPS_PER_WORD,
            bound_ms=b, bound_by=by,
            per_step=step_share))
        del out
        torch.cuda.empty_cache()

    # one page-batch gather: all B*P pages of the step, each with its own
    # tenant key and nonce (k and v each: 2 per step)
    n_gather = SLOTS * MAX_PAGES
    page_rows = 40 * PAGE * 8
    page_keys = bits((n_gather, 2), torch.int32)
    nonces = bits((n_gather,), torch.int32)
    ct = bits((n_gather, page_rows, 64), torch.int16)
    ctr_case("page gather [32 pages x 40x16x8 rows x 64 bf16]", ct,
             cipher.derive_tensor_key(
                 cipher.derive_key(page_keys, kv_pager.KV_K_DOMAIN), nonces),
             step_share=2)
    mk = kv_pager._page_mac_key(page_keys, nonces)
    pw = page_rows * 64 // 2
    keys = mac.mac_keys(mk, pw // kv_pager.page_tag_count(pw, CHUNK_WORDS),
                        kv_pager.KV_K_DOMAIN)
    mac_case("page gather [32 pages x 163840 words, cw 128]",
             ct.reshape(n_gather, 1, -1), keys, step_share=2)
    del ct
    # one slot seal of the decode write-back: explicit, non-contiguous rows
    slots = torch.tensor([3, 7, 15, 0], device="cuda")
    rows = kv_pager.slot_rows(40, PAGE, 8, slots).reshape(SLOTS, -1)
    x = bits((SLOTS, 40 * 8, 64), torch.int16)
    ctr_case("slot seal [4 lanes x 320 rows x 64 bf16, explicit rows]", x,
             cipher.derive_tensor_key(page_keys[:SLOTS], nonces[:SLOTS]),
             rows.contiguous(), step_share=2)
    # flat tag_root over one slot: 10,240 words in chunks of 128, then the
    # 80 chunk tags padded to one more chunk
    words = bits((SLOTS, 1, 40 * 8 * 64 // 2), torch.int32)
    skeys = mac.mac_keys(mk[:SLOTS], CHUNK_WORDS, kv_pager.KV_K_DOMAIN)
    mac_case("tag_root of one slot [4 x 10240 words, cw 128]", words, skeys,
             step_share=2)
    mac_case("tag_root combine [4 x 128 words, cw 128]",
             bits((SLOTS, 1, CHUNK_WORDS), torch.int32), skeys, step_share=2)
    # every weight leaf, as unsealed inside each step
    for path, leaf in _tree_paths(sealed).items():
        e = leaf.ct.shape[-1]
        x = leaf.ct.reshape(1, -1, e)
        tkey = cipher.derive_tensor_key(provider_key, leaf.nonce)[None]
        ctr_case(f"weight {path} {list(leaf.ct.shape)}", x,
                 tkey.contiguous())
        last_w = -(-e * x.element_size() // 4)
        cw = last_w // mac.chunk_count(last_w, leaf.spec.chunk_words)
        lkeys = mac.mac_keys(mac.nonce_mac_key(provider_key, leaf.nonce,
                                                 leaf.spec.mac_domain), cw,
                             leaf.spec.mac_domain)[None]
        mac_case(f"weight {path} {list(leaf.ct.shape)}", x, lkeys)
    # the sharded train step's blocks: model rank 1's columns of one layer
    # of w_gate against the leaf's global counters (col0 4096, whole
    # Threefry blocks), a block whose columns start inside a counter block
    # (col0 3, the element-wise path), and the MAC of rank 1's own chunks
    # of that layer, its tags moved to their place in the leaf
    # (mac.reposition) equal to the whole rows' tags
    leaf = sealed["layers"]["mlp"]["w_gate"]
    tkey = cipher.derive_tensor_key(provider_key, leaf.nonce)[None]
    rows, width = leaf.ct.shape[1], leaf.ct.shape[-1]
    half = width // 2
    block = leaf.ct[0, :, half:].contiguous()[None]
    ctr_case(f"sharded block w_gate[0] [{rows} x {half} of {width} bf16, "
             f"col0 {half}]", block, tkey, col0=half)
    ctr_case("sharded block [1024 x 1000 bf16, col0 3]",
             bits((1, 1024, 1000), torch.int16), tkey, col0=3)
    nc = mac.chunk_count(width // 2, leaf.spec.chunk_words)
    lkeys = mac.mac_keys(mac.nonce_mac_key(provider_key, leaf.nonce,
                                           leaf.spec.mac_domain),
                         width // 2 // nc, leaf.spec.mac_domain)
    mac_case(f"sharded block w_gate[0] [{rows} x {half} of {width} bf16, "
             f"own chunks]", block, lkeys[None])
    got = mac_ops.mac_tags(block, lkeys[None])[0]
    n = got.shape[-1]
    r = torch.arange(rows, device="cuda")[:, None]
    c = torch.arange(n, device="cuda")
    moved = mac.reposition(got, lkeys[0], r * n + c, r * nc + nc - n + c)
    whole = mac_ops.mac_tags(leaf.ct[0][None].contiguous(), lkeys[None])[0]
    results["tree_mac"][-1]["mismatches"] += int(
        (moved != whole[:, nc - n:]).sum())
    return results


def _tree_paths(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _tree_paths(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def serve(cfg, sealed, provider, tenants, profiler):
    """The main path: four requests through the sealed paged engine."""
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.serve.runner import Runner, Request
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.kv_pager import PagedKVPool

    pool = PagedKVPool(n_pages=N_PAGES, page_size=PAGE, n_layers=cfg.n_layers,
                       n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                       dtype=cfg.act_dtype, chunk_words=CHUNK_WORDS,
                       open_pages=True, profiler=profiler, device="cuda")
    eng = PagedEngine(cfg=cfg, params=sealed, channel=provider, pool=pool,
                      max_slots=SLOTS, max_pages=MAX_PAGES,
                      prefill_chunk=PREFILL_CHUNK, profiler=profiler)
    runner = Runner(eng, provider=provider)
    rng = np.random.RandomState(SEED)
    names = sorted(tenants)
    reqs = [Request(i, names[i % 2],
                    rng.randint(0, cfg.vocab, n).astype(np.int32), MAX_NEW,
                    tenants[names[i % 2]]) for i, n in enumerate(PROMPTS)]
    for r in reqs:
        runner.admit(r)
    steps = []
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    while runner.live:
        for kind, fn in (("prefill", runner.prefill_step),
                         ("decode", runner.decode_step)):
            c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
            f0 = fa_ops.flash_forward.launches
            closes0 = pool.stats["page_closes"]
            ev = {"emitted": [], "finished": [], "poisoned": []}
            if fn(ev):
                steps.append(dict(
                    kind=kind, ctr=ctr_ops.ctr_xor.launches - c0,
                    mac=mac_ops.mac_tags.launches - m0,
                    flash=fa_ops.flash_forward.launches - f0,
                    closes=pool.stats["page_closes"] - closes0,
                    poisoned=ev["poisoned"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, steps, wall, read_launches()


def tamper(eng, tenants, provider, vocab):
    """Flip a page bit of tenant A, then a weight bit; read who poisons."""
    from repro_torch.serve.runner import Runner, Request

    runner = Runner(eng, provider=provider)
    rng = np.random.RandomState(SEED + 2)
    names = sorted(tenants)
    reqs = [Request(100 + i, names[i % 2],
                    rng.randint(0, vocab, n).astype(np.int32), 8,
                    tenants[names[i % 2]])
            for i, n in enumerate((9, 12, 10, 11))]
    for r in reqs:
        runner.admit(r)
    ev = {"emitted": [], "finished": [], "poisoned": []}
    runner.prefill_step(ev)
    profile = profile_step(lambda: runner.decode_step(ev))
    check(not ev["poisoned"], f"clean tamper-phase step poisoned {ev}")
    a_rids = sorted(r.rid for r in reqs if r.tenant == names[0])
    for r in reqs:
        if r.tenant == names[0]:
            eng.pool.k_ct[r.pages[0], 0, 0, 0, 0] ^= 1
    ev = {"emitted": [], "finished": [], "poisoned": []}
    runner.decode_step(ev)
    page_poisoned = sorted(ev["poisoned"])
    check(page_poisoned == a_rids,
          f"page tamper poisoned {page_poisoned}, tenant A holds {a_rids}")
    survivors = sorted(r.rid for r in runner.live)
    eng.params["layers"]["mlp"]["w_down"].ct[7, 100, 5] ^= 1 << 3
    ev = {"emitted": [], "finished": [], "poisoned": []}
    runner.decode_step(ev)
    check(sorted(ev["poisoned"]) == survivors and survivors,
          f"weight tamper poisoned {ev['poisoned']}, live {survivors}")
    eng.params["layers"]["mlp"]["w_down"].ct[7, 100, 5] ^= 1 << 3
    return {"page": page_poisoned, "weight": sorted(ev["poisoned"])}, profile


def kernel_rows(prof) -> dict:
    """{kernel name: [launches, device ms]} of a finished torch.profiler
    run, summed straight from its raw events (the device's activities:
    kernels, copies, sets).  It leaves out the tree of operator events
    that ``key_averages`` builds first, whose post-processing of a train
    step's ~100k launches took 30-80 s; the device rows it would give are
    the same."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            r = rows.setdefault(e.name(), [0, 0.0])
            r[0] += 1
            r[1] += e.duration_ns() / 1e6
    return rows


SCAN_KERNELS = ("wkv6_", "ssd_")   # the recurrence scans' kernel names


def profile_step(step):
    """One step under torch.profiler: wall ms, device-busy ms (sum of the
    kernels' device times), launches, the top kernels by device time and
    the recurrence scans' kernels' device ms summed (``scans_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(ms for _, ms in rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:10]
    scans_ms = sum(ms for name, (_, ms) in rows.items()
                   if any(k in name for k in SCAN_KERNELS))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "scans_ms": scans_ms,
            "kernel_launches": sum(n for n, _ in rows.values()),
            "top": [{"op": name[:60], "device_ms": ms, "count": n}
                    for name, (n, ms) in top]}


def attention_bound(B, K, G, hd, t_valid, verify):
    """Bytes, operations and bound of one sealed-attention call: q read and
    the output written once, each valid K and V row (and its tag when
    verifying) read once; per valid row hd/4 Threefry blocks (and hd/2 MAC
    words when verifying) of integer work, plus the f32 dot products.  The
    bound counts the ALU-pipe operations (alu_ops); bound_ms_74 counts all
    74 of a Threefry block and 20 of a MAC word on the ALU pipe."""
    rows = B * t_valid * K
    nbytes = (2 * B * K * G * hd * 2 + 2 * rows * hd * 2 + B * K * 4
              + (2 * rows * 4 if verify else 0))
    ops = 2 * rows * (hd // 4) * CTR_OPS_PER_BLOCK
    alu = 2 * rows * (hd // 4) * CTR_ALU_OPS_PER_BLOCK
    if verify:
        ops += 2 * rows * (hd // 2) * MAC_OPS_PER_WORD
        alu += 2 * rows * (hd // 2) * MAC_ALU_OPS_PER_WORD
    flops = 4 * B * K * G * t_valid * hd
    # the INT32 and FP32 pipes issue side by side, so the slower one bounds
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(alu / INT32_OPS_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    to74 = max(ops / INT32_OPS_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    return dict(bytes=nbytes, ops=ops, alu_ops=alu, flops=flops,
                bound_ms=max(tb, to), bound_ms_74=max(tb, to74),
                bound_by="bytes" if tb >= to else "operations")


def sdpa_call(q4, kd, vd, t_valid):
    """One PyTorch attention call over the already-decrypted cache: the
    attention-only yardstick (it neither decrypts nor verifies, and the
    port never calls it)."""
    import torch.nn.functional as F

    B, K, G, hd = q4.shape
    q = q4.reshape(B, K * G, 1, hd)
    k = kd[:, :t_valid].permute(0, 2, 1, 3).contiguous()
    v = vd[:, :t_valid].permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)


def timings(kernel, plain, library) -> dict:
    """The kernel's and the library call's device time per call (profiler,
    with the kernel rows it saw per call) and their CUDA-event time around
    one call (host time included), and the plain version's CUDA-event
    time."""
    ms, seen = device_busy(kernel)
    return dict(ms=ms, kernels_per_call=seen, event_ms=device_ms(kernel),
                library_ms=device_busy_ms(library),
                library_event_ms=device_ms(library),
                plain_ms=device_ms(plain, reps=3))


def attention_checks():
    """(a) The sealed-attention kernel against its plain version at the
    fixed phase's shape (B 8, K 8, G 4, hd 64): T 1024 with t_valid 1, 700
    and 1024 and an odd T 1000, verify off and on; then one flipped
    ciphertext bit of K or V inside and past t_valid = 700.  At t_valid 700
    two faulty plain versions (the tail of the kernel's last tile unmasked,
    the last valid row dropped) must fall outside the limit."""
    from repro_torch.core import cipher, mac
    from repro_torch.kernels.sealed_attention import ops as sa_ops
    from repro_torch.kernels.sealed_attention import ref as sa_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, K, G, hd = FIXED_B, 8, 4, 64
    cases, tamper, controls = [], {}, {}
    for T, tvs in ((FIXED_MAX_LEN, (1, 700, FIXED_MAX_LEN)), (1000, (1000,))):
        q = torch.randn((B, K, G, hd), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, T, K, hd), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, T, K, hd), generator=g, device="cuda").bfloat16()
        master = torch.randint(-2**31, 2**31 - 1, (2,), generator=g,
                               device="cuda", dtype=torch.int64).to(torch.int32)
        k_ct, v_ct, k_tags, v_tags = sa_ops.seal_cache(k, v, master, 11, 12)
        keys = (cipher.derive_tensor_key(master, 11),
                cipher.derive_tensor_key(master, 12),
                mac.mac_keys(mac.nonce_mac_key(master, 11), hd // 2))
        for tv in tvs:
            args = (q, k_ct, v_ct, k_tags, v_tags, *keys, tv)
            for verify in (False, True):
                out, bad = sa_ops.sealed_decode_attention(*args, verify=verify)
                want, want_bad = sa_ref.sealed_decode_attention_words_ref(
                    *args, verify)
                err = (out.float() - want.float()).abs().max().item()
                name = f"T {T}, t_valid {tv}, verify {verify}"
                check(bool(torch.isfinite(out.float()).all())
                      and sa_ref.out_excess(out, want) <= 0,
                      f"sealed_attention off by {err} at {name}")
                check(torch.equal(bad, want_bad) and not bad.any(),
                      f"sealed_attention bad counts wrong at {name}")
                cases.append(dict(
                    shape=name, max_abs_err=err,
                    graph_ms=graph_ms(lambda: sa_ops.sealed_decode_attention(
                        *args, verify=verify)),
                    **timings(
                        lambda: sa_ops.sealed_decode_attention(
                            *args, verify=verify),
                        lambda: sa_ref.sealed_decode_attention_words_ref(
                            *args, verify),
                        sdpa_call(q, k, v, tv)),
                    **attention_bound(B, K, G, hd, tv, verify)))
        if T != FIXED_MAX_LEN:
            continue
        chunk = sa_ops.chunk_rows(hd)
        for fault, wrong_tv in (("unmasked tail", -(-700 // chunk) * chunk),
                                ("dropped row", 699)):
            want, _ = sa_ref.sealed_decode_attention_words_ref(
                q, k_ct, v_ct, None, None, *keys[:2], None, 700, False)
            wrong, _ = sa_ref.sealed_decode_attention_words_ref(
                q, k_ct, v_ct, None, None, *keys[:2], None, wrong_tv, False)
            controls[fault] = (wrong.float() - want.float()).abs().max().item()
            check(sa_ref.out_excess(wrong, want) > 0,
                  f"the output limit passes a {fault} at t_valid 700")
        for t in (350, 900):
            for which, ct in (("k", k_ct), ("v", v_ct)):
                ct[3, t, 5, 9] ^= 1 << 6
                args = (q, k_ct, v_ct, k_tags, v_tags, *keys, 700)
                _, bad = sa_ops.sealed_decode_attention(*args, verify=True)
                _, want_bad = sa_ref.sealed_decode_attention_words_ref(
                    *args, True)
                ct[3, t, 5, 9] ^= 1 << 6
                expect = torch.zeros_like(bad)
                expect[3, 5] = int(t < 700)
                check(torch.equal(bad, expect) and torch.equal(want_bad,
                                                               expect),
                      f"flipped {which} bit at t {t}: bad {bad.tolist()}")
                tamper[f"{which} at t {t}"] = int(bad.sum())
    return cases, tamper, controls


def matmul_bound(M, K, N, verify=True):
    """Bytes, operations and bound of one sealed matmul: A, B (and their
    tags) read once and C written once; per four bf16 of A and B one
    Threefry block and, verifying, per two one MAC word; 2MKN FLOP on the
    tensor cores.  The integer pipe and the tensor cores run side by
    side, so the slower one bounds the operations (ALU-pipe operations, as
    in attention_bound; bound_ms_74 with all 74 and 20).  keystream_ops is
    the kernel's own floor: the keystream its 128 x 256 blocks regenerate in
    clusters of cluster[0] x cluster[1] (ops.keystream_ops)."""
    from repro_torch.kernels.sealed_matmul import ops as smm_ops

    elems = M * K + K * N
    nbytes = 2 * elems + 2 * M * N + (4 * elems // 256 if verify else 0)
    ops = elems // 4 * CTR_OPS_PER_BLOCK
    alu = elems // 4 * CTR_ALU_OPS_PER_BLOCK
    if verify:
        ops += elems // 2 * MAC_OPS_PER_WORD
        alu += elems // 2 * MAC_ALU_OPS_PER_WORD
    flops = 2 * M * K * N
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(alu / INT32_OPS_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    to74 = max(ops / INT32_OPS_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    return dict(bytes=nbytes, ops=ops, alu_ops=alu, flops=flops,
                bound_ms=max(tb, to), bound_ms_74=max(tb, to74),
                bound_by="bytes" if tb >= to else "operations",
                keystream_ops=smm_ops.keystream_ops(M, K, N),
                cluster=list(smm_ops.cluster_shape(M, N)))


def matmul_checks(sealed, provider_key):
    """(d) The sealed matmul against its plain version: 256^3 with verify
    on and off, (512, 256, 512) with a flipped A bit and, apart, a flipped
    B bit, and granite's two MLP products of one 8192-token microbatch (B
    the sealed w_gate and w_down of layer 0).  C within two bf16 ulps plus
    K 2^-24 max|A| max|B| (``ref.c_excess``), ``bad`` exact; at the w_gate
    product two faulty plain versions (the last k-step skipped, B's
    keystream one counter row off) must fall outside that limit.  Then the
    entry point, ``ops.matmul``, over both MLP products with the launch
    counts zeroed: the main path of this kernel."""
    from repro_torch.core import cipher, mac
    from repro_torch.kernels.ctr_cipher.ref import ctr_xor_ref
    from repro_torch.kernels.sealed_matmul import ops as smm_ops
    from repro_torch.kernels.sealed_matmul import ref as smm_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    master = torch.randint(-2**31, 2**31 - 1, (2,), generator=g,
                           device="cuda", dtype=torch.int64).to(torch.int32)
    na, nb = 21, 22
    keys = (cipher.derive_tensor_key(master, na),
            cipher.derive_tensor_key(master, nb),
            mac.mac_keys(mac.nonce_mac_key(master, na), 128))

    def operands(a, b):
        a_ct, ta = smm_ops.seal_operand(a, master, na, 128, mac_nonce=na)
        b_ct, tb = smm_ops.seal_operand(b, master, nb, 128, mac_nonce=na)
        atol = smm_ref.c_atol(a.shape[1], a.float().abs().max().item(),
                              b.float().abs().max().item())
        return [a_ct, b_ct, ta, tb, *keys], atol

    def compare(name, args, atol, verify=True):
        c, bad = smm_ops.sealed_matmul(*args, verify=verify)
        want, want_bad = smm_ref.sealed_matmul_ref(*args, verify)
        excess = smm_ref.c_excess(c, want, atol)
        err = (c.float() - want.float()).abs().max().item()
        check(excess <= 0, f"sealed_matmul off by {err} at {name}")
        check(torch.equal(bad, want_bad),
              f"sealed_matmul bad grid wrong at {name}")
        return c, bad, want, dict(shape=name, max_abs_err=err, excess=excess,
                                  atol=atol, bad_sum=int(bad.sum()))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).bfloat16()

    cases, tamper, controls = [], {}, {}
    args, atol = operands(randn(256, 256), randn(256, 256, scale=1 / 16))
    for verify in (True, False):
        cases.append(compare(f"256x256x256, verify {verify}", args, atol,
                             verify)[3])
    args, atol = operands(randn(512, 256), randn(256, 512, scale=1 / 16))
    for which, (r, c) in (("A", (17, 93)), ("B", (200, 301))):
        ct = args[0 if which == "A" else 1]
        ct[r, c] ^= 1 << 5
        _, bad, _, rec = compare(f"512x256x512, {which} bit flipped", args,
                                 atol)
        ct[r, c] ^= 1 << 5
        expect = torch.zeros_like(bad)
        if which == "A":
            expect[r // 256, :] = 1
        else:
            expect[:, c // 256] = 1
        check(torch.equal(bad, expect),
              f"flipped {which} bit: bad {bad.tolist()}")
        tamper[which] = bad.tolist()
        cases.append(rec)

    mlp, main_args = [], []
    for name, M, K, N in MLP_PRODUCTS:
        leaf = sealed["layers"]["mlp"][name]
        b = cipher.unseal_bits(leaf.ct[0], provider_key, leaf.nonce,
                               torch.bfloat16)
        check(tuple(b.shape) == (K, N), f"{name} of layer 0 is {b.shape}")
        a = randn(M, K)
        args, atol = operands(a, b)
        label = f"{M}x{K}x{N} ({name} of layer 0)"
        c, _, want, rec = compare(label, args, atol)
        if name == "w_gate":
            cut = (a[:, :K - 32].float() @ b[:K - 32].float()).bfloat16()
            controls["last k-step skipped"] = smm_ref.c_excess(cut, want,
                                                               atol)
            rows = (torch.arange(K, dtype=torch.int32, device="cuda")
                    + 1)[None]
            b_off = ctr_xor_ref(args[1][None], keys[1][None], rows)[0]
            off = (a.float() @ b_off.view(torch.bfloat16).float()).bfloat16()
            controls["B keystream one row off"] = smm_ref.c_excess(
                off, want, atol)
            del cut, b_off, off
            for fault, ex in controls.items():
                check(ex > 0, f"the sealed_matmul limit passes a {fault}")
        rec.update(**timings(lambda: smm_ops.sealed_matmul(*args),
                             lambda: smm_ref.sealed_matmul_ref(*args),
                             lambda: torch.matmul(a, b)),
                   **matmul_bound(M, K, N))
        mlp.append(rec)
        main_args.append((args, c))
        del want
        torch.cuda.empty_cache()

    # the main path: the entry point over both products
    torch.cuda.synchronize()
    zero_launches()
    for args, c in main_args:
        out, n_bad = smm_ops.matmul(args[0], args[1], args[2], args[3],
                                    master, na, nb)
        check(int(n_bad) == 0 and torch.equal(out, c),
              "the sealed_matmul entry point disagrees with its kernel")
    torch.cuda.synchronize()
    launches = read_launches()["sealed_matmul"]
    check(launches == len(MLP_PRODUCTS),
          f"sealed_matmul entry point launched {launches}")
    return dict(cases=cases, mlp=mlp, tamper=tamper, controls=controls,
                launches=launches)


def fixed_phase(cfg, sealed, provider):
    """(b) The fixed-slot ServeEngine at full width: 8 prompts of 1000
    tokens, 16 new tokens each, first with the sealed cache unsealed per
    layer, then with the sealed flash-decode kernel.  Returns the two runs,
    the per-layer comparison and the weight-tamper result."""
    from repro_torch.core import cipher
    from repro_torch.kernels.sealed_attention import ops as sa_ops
    from repro_torch.kernels.sealed_attention import ref as sa_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (FIXED_B, FIXED_PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg=cfg, params=sealed, channel=provider,
                      max_len=FIXED_MAX_LEN)
    decode = eng._decode
    rec = {}

    def watched_decode(params, cache, tokens):
        n0 = sa_ops.sealed_decode_attention.launches
        logits, cache = decode(params, cache, tokens)
        rec["logits"].append(logits.float())
        rec["sa"].append(sa_ops.sealed_decode_attention.launches - n0)
        rec["cache"] = cache
        return logits, cache

    eng._decode = watched_decode
    runs = {}
    for fused in (False, True):
        eng.cfg = cfg.with_(fused_sealed_attention=fused)
        rec.update(logits=[], sa=[])
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = eng.generate({"tokens": prompts}, FIXED_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[fused] = dict(tokens=out, wall=wall, launches=read_launches(),
                           logits=rec["logits"], sa_per_step=rec["sa"])
        # one more decode step on the last cache, under the profiler
        last = rec["cache"]
        tok = torch.as_tensor(out[:, -1], device="cuda")
        runs[fused]["profile"] = profile_step(
            lambda: decode(sealed, last, tok))
        name = "fused" if fused else "unfused"
        check(out.shape == (FIXED_B, FIXED_NEW)
              and ((out >= 0) & (out < cfg.vocab)).all(),
              f"{name} fixed run gave bad tokens")
        check(all(bool(torch.isfinite(x).all()) for x in rec["logits"]),
              f"{name} fixed run has non-finite (poisoned) logits")
        want = cfg.n_layers if fused else 0
        check(rec["sa"] == [want] * (FIXED_NEW - 1),
              f"{name} decode steps launched sealed_attention {rec['sa']}")
        la = runs[fused]["launches"]
        check(la["ctr_cipher"] > 0 and la["tree_mac"] > 0,
              f"{name} fixed run launched {la}")
    plain, fused = runs[False], runs[True]
    check((plain["tokens"][:, 0] == fused["tokens"][:, 0]).all(),
          "fused and unfused first tokens differ")
    logit_err = (fused["logits"][0] - plain["logits"][0]).abs().max().item()
    check(logit_err <= LOGIT_TOL,
          f"first decode logits: fused vs unfused off by {logit_err}")

    # one layer of the last fused step's cache: kernel vs CTR unseal + plain
    # attention, CUDA events around each (host work inside the window too)
    cache = rec["cache"]
    key, tval = eng._kv_key, int(cache["pos"])
    nk, nv = transformer._kv_nonces(cache["nonce"], 0)
    kc, vc = cache["k_ct"][0], cache["v_ct"][0]
    B, T, K, hd = kc.shape
    G = cfg.n_heads // K
    q4 = torch.randn((B, K, G, hd), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(
                         SEED + 6)).bfloat16()
    tkeys = (cipher.derive_tensor_key(key, nk),
             cipher.derive_tensor_key(key, nv))
    args = (q4, kc, vc, None, None, *tkeys, None, tval)
    out, _ = sa_ops.sealed_decode_attention(*args, verify=False)
    want, _ = sa_ref.sealed_decode_attention_words_ref(*args, False)
    err = (out.float() - want.float()).abs().max().item()

    def unfused():
        kd = cipher.unseal_bits(kc, key, nk, torch.bfloat16)
        vd = cipher.unseal_bits(vc, key, nv, torch.bfloat16)
        m = (torch.arange(T, device="cuda") < tval)[None, :, None, None]
        zero = torch.zeros((), dtype=torch.bfloat16, device="cuda")
        return L.gqa_attention(q4.reshape(B, 1, K * G, hd),
                               torch.where(m, kd, zero),
                               torch.where(m, vd, zero), causal=False,
                               t_valid=tval)

    def fused_layer():
        return sa_ops.sealed_decode_attention(
            q4, kc, vc, None, None, cipher.derive_tensor_key(key, nk),
            cipher.derive_tensor_key(key, nv), None, tval, verify=False)

    via_unfused = unfused().reshape(B, K, G, hd)
    err_unfused = (via_unfused.float() - out.float()).abs().max().item()
    check(sa_ref.out_excess(out, want) <= 0
          and sa_ref.out_excess(out, via_unfused) <= 0,
          f"fixed-phase layer: kernel off by {err} (plain version), "
          f"{err_unfused} (unfused path)")
    kd = cipher.unseal_bits(kc, key, nk, torch.bfloat16)
    vd = cipher.unseal_bits(vc, key, nv, torch.bfloat16)
    def kernel():
        return sa_ops.sealed_decode_attention(*args, verify=False)

    sdpa = sdpa_call(q4, kd, vd, tval)
    layer = dict(
        t_valid=tval, max_abs_err=err, max_abs_err_vs_unfused=err_unfused,
        fused_event_ms=device_ms(fused_layer),
        unfused_event_ms=device_ms(unfused),
        **dict(zip(("unfused_ms", "unfused_kernels_per_call"),
                   device_busy(unfused))),
        **timings(kernel,
                  lambda: sa_ref.sealed_decode_attention_words_ref(*args,
                                                                   False),
                  sdpa),
        **attention_bound(B, K, G, hd, tval, False))
    # This late in the run the profiler keeps only part of the launches
    # (kernels_per_call < 1), so the layer's device times are taken from a
    # CUDA graph of the calls; the profiler's are kept beside them.
    # a launch captured in a graph zeroes counters of its own, which a
    # launch outside one does not: ms holds that zeroing (counters_ms, in
    # a graph of 100 to spread the graph's own launch thin)
    layer.update(profiler_ms=layer["ms"], ms=graph_ms(kernel),
                 library_profiler_ms=layer["library_ms"],
                 library_ms=graph_ms(sdpa),
                 counters_ms=graph_ms(lambda: sa_ops._counters(
                     q4.device, None, B * K, True), reps=100))
    del kd, vd, cache, rec["cache"]

    # a flipped weight bit poisons every lane of the fused engine
    flat = sealed["layers"]["mlp"]["w_down"].ct.view(-1)
    flat[flat.numel() // 3] ^= 1 << 3
    rec.update(logits=[], sa=[])
    eng.generate({"tokens": prompts[:, :16]}, 2)
    flat[flat.numel() // 3] ^= 1 << 3
    poisoned = all(bool(torch.isnan(x).all()) for x in rec["logits"])
    check(bool(rec["logits"]) and poisoned,
          "a flipped weight bit did not poison every fixed-slot lane")
    torch.cuda.empty_cache()
    return runs, layer, logit_err


def gateway_phase(cfg):
    """(c) SecureGateway at full width: two tenants, a 32-token prefix
    matched by two requests, four low-priority requests and, four steps
    later, one of priority 5 that preempts; then a flipped page bit in each
    of one tenant's requests."""
    from repro_torch.models import transformer
    from repro_torch.obs import MonitorConfig
    from repro_torch.serve import SecureGateway

    params = transformer.init(torch.Generator(device="cuda").manual_seed(SEED),
                              cfg, "cuda")
    # the phase tampers on purpose: no automatic quarantine
    gw = SecureGateway(cfg, params, max_slots=SLOTS, page_size=PAGE,
                       n_pages=N_PAGES, max_pages_per_seq=MAX_PAGES,
                       prefill_chunk=PREFILL_CHUNK,
                       monitor_config=MonitorConfig(tamper_storm_count=0),
                       device="cuda")
    del params
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 4)

    def prompt(n):
        return rng.randint(0, cfg.vocab, n).astype(np.int32)

    prefix = prompt(32)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    gw.register_prefix(prefix)
    rids = [gw.submit("tenant_a", np.concatenate([prefix, prompt(8)]), 16),
            gw.submit("tenant_b", np.concatenate([prefix, prompt(20)]), 16),
            gw.submit("tenant_a", prompt(40), 16),
            gw.submit("tenant_b", prompt(27), 16)]
    for _ in range(4):
        gw.step()
    rids.append(gw.submit("tenant_b", prompt(24), 8, priority=5))
    gw.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    m = gw.metrics()
    reqs = [gw.scheduler.requests[r] for r in rids]
    audit = gw.verify_audit()
    check(all(r.status == "done" for r in reqs),
          f"gateway statuses {[r.status for r in reqs]}")
    check(m["swap_outs"] >= 1 and m["swap_ins"] >= 1,
          f"no swap: out {m['swap_outs']}, in {m['swap_ins']}")
    check(m["prefix_hits"] >= 1, f"prefix hits {m['prefix_hits']}")
    check(audit["ok"], f"audit chain does not verify: {audit}")
    check(launches["ctr_cipher"] > 0 and launches["tree_mac"] > 0,
          f"gateway run launched {launches}")
    result = dict(
        wall=wall, tokens=m["tokens"], tok_per_s=m["tokens"] / wall,
        swap_outs=m["swap_outs"], swap_ins=m["swap_ins"],
        prefix_hits=m["prefix_hits"], prefix_misses=m["prefix_misses"],
        audit_records=len(gw.audit.records), launches=launches,
        sealed_bytes_per_token=m["sealed_bytes_per_token"])

    # tamper: one flipped ciphertext bit in a page of each of tenant_a's
    # requests poisons those and no request of tenant_b
    a = [gw.submit("tenant_a", prompt(n), 6) for n in (30, 21)]
    b = [gw.submit("tenant_b", prompt(n), 6) for n in (25, 33)]
    gw.step()
    result["profile"] = profile_step(gw.step)
    for rid in a:
        gw.pool.k_ct[gw.scheduler.requests[rid].pages[0], 0, 0, 0, 0] ^= 1
    gw.drain()
    status = {rid: gw.scheduler.requests[rid].status for rid in a + b}
    check(all(status[r] == "poisoned" for r in a)
          and all(status[r] == "done" for r in b),
          f"page tamper of tenant_a gave {status} (a {a}, b {b})")
    result["tamper"] = {"tenant_a": [status[r] for r in a],
                        "tenant_b": [status[r] for r in b]}
    return result


def train_phase(cfg):
    """(e) Sealed training of granite-3-2b at full width and depth: the
    state (params, mu, nu: 26.3 GB of ciphertext) sealed by ``seal_state``,
    three steps of two 4096-token microbatches through ``make_train_step``
    (resealing in place), one more under the profiler, then one flipped
    bit in a sealed ``mu`` leaf: seal_ok False and a poisoned state."""
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.core.channel import SecureChannel
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.models import transformer
    from repro_torch.models.config import TRAIN_4K
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step, seal_state

    channel = SecureChannel.establish(device="cuda")
    key, sec = channel.jkey, channel.config
    opt = AdamW(lr=3e-4)                  # f32 moments, as in the reference
    params = transformer.init(torch.Generator(device="cuda").manual_seed(SEED),
                              cfg, "cuda")
    state = seal_state(opt.init(params), key, sec)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sealed_bytes = sum(leaf.nbytes_ct for tree in (state.params, state.mu,
                                                    state.nu)
                       for leaf in sealed_lib.tree_leaves(tree))
    step = make_train_step(transformer, cfg, opt, sec, key, in_place=True)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_4K.seq_len, batch=1)
    reduced = {"global_batch": [TRAIN_4K.global_batch, TRAIN_ACCUM],
               "microbatch": [TRAIN_4K.microbatch, 1],
               "checkpoint": "none at full size (one save writes the 26 GB "
                             "state and hashes it on the host)"}

    def batch(i):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in data.microbatches_at(i, TRAIN_ACCUM).items()}

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    steps = []
    for i in range(TRAIN_STEPS):
        b = batch(i)
        c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
        f0, b0 = fa_ops.flash_forward.launches, fa_ops.flash_backward.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        steps.append(dict(wall_s=time.perf_counter() - t0,
                          loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          seal_ok=bool(m["seal_ok"]),
                          ctr=ctr_ops.ctr_xor.launches - c0,
                          mac=mac_ops.mac_tags.launches - m0,
                          flash_forward=fa_ops.flash_forward.launches - f0,
                          flash_backward=(fa_ops.flash_backward.launches
                                          - b0)))
        s_ = steps[-1]
        check(np.isfinite(s_["loss"]) and s_["seal_ok"],
              f"train step {i}: {s_}")
        check(s_["ctr"] > 0 and s_["mac"] > 0,
              f"train step {i} launched no kernel: {s_}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == TRAIN_STEPS, f"state at step {state.step}")
    held = {"state": state}

    def one_step():
        held["state"], _ = step(held["state"], batch(TRAIN_STEPS))

    b = None
    del state
    profile = profile_step(one_step)
    # a flipped bit in one sealed mu leaf poisons everything written
    state = held.pop("state")
    mu0 = sealed_lib.tree_leaves(state.mu)[0]
    mu0.ct.view(-1)[mu0.ct.numel() // 3] ^= 1 << 7
    state, m = step(state, batch(TRAIN_STEPS + 1))
    norm, _ = sealed_lib.unseal(state.params["final_norm"], key)
    nu0, _ = sealed_lib.unseal(sealed_lib.tree_leaves(state.nu)[0], key)
    poisoned = (not bool(m["seal_ok"]) and bool(torch.isnan(norm).all())
                and bool(torch.isnan(nu0).all()))
    check(poisoned, "a flipped mu bit did not poison the train state")
    del state, norm, nu0, b
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_bytes=peak, launches=launches,
                sealed_bytes=sealed_bytes, profile=profile, reduced=reduced,
                tokens_per_step=TRAIN_4K.seq_len * TRAIN_ACCUM)


def smoke_train_reference():
    """The smoke config trained for 4 steps on the CPU and on the card,
    through ``Supervisor`` with a failure at step 2, a checkpoint every 2
    steps and a lane budget of 3 reseals: (losses, events) of each."""
    import tempfile

    from repro_torch import configs
    from repro_torch.core.policy import SecurityConfig
    from repro_torch.core.sealed import (ResealCounter, tree_leaves,
                                         tree_unflatten)
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import make_refresh_fn, make_train_step, seal_state
    from repro_torch.train.fault import FailureInjector, Supervisor

    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(SEED), cfg, "cpu")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4)
    sec = SecurityConfig()
    out = {}
    for dev in ("cpu", "cuda"):
        key = torch.tensor([0x5EC0DE, 0xFACADE], dtype=torch.int32,
                           device=dev)
        opt = AdamW(lr=1e-3)
        p = tree_unflatten(params, [x.to(dev) for x in tree_leaves(params)])
        step = make_train_step(transformer, cfg, opt, sec, key)
        losses = []

        def stepper(s, b, step=step, losses=losses):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
            return s, m

        def batch_fn(i, dev=dev):
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in data.microbatches_at(i, 2).items()}

        with tempfile.TemporaryDirectory() as d:
            sup = Supervisor(step_fn=stepper, batch_fn=batch_fn, ckpt_dir=d,
                             key_bytes=b"\xabK" * 16, save_every=2,
                             injector=FailureInjector(fail_at_steps=(2,)),
                             lane_guard=ResealCounter(limit=3),
                             refresh_fn=make_refresh_fn(key, sec))
            _, _, events = sup.run(seal_state(opt.init(p), key, sec), 4)
        out[dev] = (losses, events)
    return out


def train_family_reduced(arch: str) -> dict:
    """The cuts of the train-families phase: {what: [published, run]}."""
    from repro_torch import configs
    from repro_torch.models.config import TRAIN_4K

    published = configs.get_config(arch)
    red = {k: [getattr(published, k), v]
           for k, v in TRAIN_FAMILY_CUTS.get(arch, {}).items()}
    red["global_batch"] = [TRAIN_4K.global_batch, 1]
    red["microbatch"] = [TRAIN_4K.microbatch, 1]
    return red


def train_family_phase(arch: str) -> dict:
    """(g) Sealed training of one more family at full width through
    ``steps.make_cell`` and ``steps.make_train_step_fn`` (in place),
    weights from a seeded torch.Generator on the card: three steps of one
    4096-token sequence (seamless: as many frame embeddings), each with a
    finite loss, seal_ok and both kernels launched; the peak memory; one
    step under the profiler; then a flipped bit in a sealed ``mu`` leaf:
    seal_ok False and a poisoned state.  For ``CROSSPOD_ARCH`` that last
    step's gradients (the f32 means the grad hook sees) are kept on the
    host for ``crosspod_check``."""
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.launch import steps
    from repro_torch.models.config import TRAIN_4K
    from repro_torch.train import seal_state

    t0 = time.perf_counter()
    cell = steps.make_cell(arch, "train_4k",
                           overrides=TRAIN_FAMILY_CUTS.get(arch),
                           device="cuda")
    cfg = cell.cfg
    params = cell.model.init(torch.Generator(device="cuda").manual_seed(SEED),
                             cfg, "cuda")
    n_params = sum(x.numel() for x in _leaves(params))
    state = seal_state(cell.opt.init(params), cell.key, cell.sec)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    sealed_bytes = sum(leaf.nbytes_ct for tree in (state.params, state.mu,
                                                    state.nu)
                       for leaf in sealed_lib.tree_leaves(tree))
    seq = TRAIN_4K.seq_len
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=1)
    extra = steps.batch_extra(cfg, seq)

    def batch(i):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in data.microbatches_at(i, 1, extra).items()}

    step = steps.make_train_step_fn(cell, in_place=True)
    scans = scan_launches_per_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out_steps = []
    for i in range(TRAIN_FAMILY_STEPS):
        b = batch(i)
        c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
        k0 = read_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        k1 = read_launches()
        out_steps.append(dict(wall_s=time.perf_counter() - t1,
                              loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              seal_ok=bool(m["seal_ok"]),
                              ctr=ctr_ops.ctr_xor.launches - c0,
                              mac=mac_ops.mac_tags.launches - m0,
                              scans={k: k1[k] - k0[k] for k in scans}))
        s_ = out_steps[-1]
        check(np.isfinite(s_["loss"]) and s_["seal_ok"],
              f"{arch} train step {i}: {s_}")
        check(s_["ctr"] > 0 and s_["mac"] > 0,
              f"{arch} train step {i} launched no kernel: {s_}")
        check(s_["scans"] == scans,
              f"{arch} train step {i} launched the scans {s_['scans']}, "
              f"not {scans}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == TRAIN_FAMILY_STEPS, f"state at {state.step}")
    held = {"state": state}
    del state, b

    def one_step():
        held["state"], _ = step(held["state"], batch(TRAIN_FAMILY_STEPS))

    t_prof = time.perf_counter()
    profile = profile_step(one_step)
    # the profiler's own time: the trace's post-processing beside the step
    profile["overhead_s"] = (time.perf_counter() - t_prof
                             - profile["wall_ms"] / 1e3)
    profile["top"] = profile["top"][:3]
    grads = []

    def keep(g, step_no):
        grads[:] = [x.cpu() for x in sealed_lib.tree_leaves(g)]
        return g

    tamper = (steps.make_train_step_fn(cell, grad_hook=keep, in_place=True)
              if arch == CROSSPOD_ARCH else step)
    state = held.pop("state")
    mu0 = sealed_lib.tree_leaves(state.mu)[0]
    mu0.ct.view(-1)[mu0.ct.numel() // 3] ^= 1 << 7
    state, m = tamper(state, batch(TRAIN_FAMILY_STEPS + 1))
    norm, _ = sealed_lib.unseal(state.params["final_norm"], cell.key)
    nu0, _ = sealed_lib.unseal(sealed_lib.tree_leaves(state.nu)[0], cell.key)
    poisoned = (not bool(m["seal_ok"]) and bool(torch.isnan(norm).all())
                and bool(torch.isnan(nu0).all()))
    check(poisoned, f"{arch}: a flipped mu bit did not poison the state")
    del state, norm, nu0, m
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(arch=arch, params=n_params, sealed_bytes=sealed_bytes,
                setup_s=setup_s, steps=out_steps, launches=launches,
                peak_bytes=peak, profile=profile,
                reduced=train_family_reduced(arch), tokens_per_step=seq,
                grads=grads, remat=cfg.remat,
                moments=cell.opt.state_dtype)


def scan_launches_per_step(cfg) -> dict:
    """The scan kernels a train step of one sequence launches: a forward
    per layer call and a backward per layer, and one more forward per
    layer that a remat unit runs again (RWKV-6: every block; Zamba2: every
    full group of attn_every layers, not the tail group)."""
    L = cfg.n_layers
    if cfg.family == "rwkv":
        again, kind = (L if cfg.remat != "none" else 0), "wkv6"
    elif cfg.family == "hybrid":
        ae = cfg.hybrid.attn_every
        again, kind = ((L // ae) * ae if cfg.remat != "none" else 0), "ssd"
    else:
        return {}
    return {f"{kind}_forward": L + again, f"{kind}_backward": L}


def scan_shapes() -> dict:
    """One layer's scan at the published configs over SCAN_SEQ tokens:
    {"wkv6": rwkv6-3b's (B, S, H, hd), "ssd": zamba2-1.2b's (B, S, H, p,
    N)}."""
    from repro_torch import configs
    from repro_torch.models import ssm

    rw = configs.get_config("rwkv6-3b")
    hd = rw.rwkv.head_dim
    _, H, P, N = ssm._m2_dims(configs.get_config("zamba2-1.2b"))
    return {"wkv6": (1, SCAN_SEQ, rw.d_model // hd, hd),
            "ssd": (1, SCAN_SEQ, H, P, N)}


def scan_bound(kind: str, backward: bool, shape) -> dict:
    """Bytes, FLOPs and bound of one scan call: each of the function's own
    inputs read and each output written once, and the FLOPs of the op's
    formula at the float32 rate outside the tensor cores (67 TFLOP/s),
    whichever is slower.  The state checkpoints (one every CHUNK tokens,
    the kernels' own choice) are not the function's: their bytes, which
    the training forward writes and the backward reads, come apart as
    ``checkpoint_bytes``, with the bound that counts them."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wkv6_scan import ops as wkv_ops

    if kind == "wkv6":
        B, S, H, hd = shape
        x, st = B * S * H * hd, B * H * hd * hd
        ck = B * wkv_ops.ref.n_chunks(S) * H * hd * hd
        # r, k, v, w, u, dy, the final state's gradient -> dr, dk, dv, dw,
        # du per (b, h), ds0; r, k, v, w, u, s0 -> y, s_out
        words = (5 * x + H * hd + st + 4 * x + B * H * hd + st
                 if backward else 4 * x + H * hd + st + x + st)
        flops = (wkv_ops.backward_flops if backward
                 else wkv_ops.forward_flops)(*shape)
    else:
        B, S, H, P, N = shape
        x, a, bc = B * S * H * P, B * S * H, B * S * N
        st = B * H * P * N
        ck = B * ssd_ops.ref.n_chunks(S) * H * P * N
        # a, dtx, B, C, dy, dh -> da, ddtx, dB and dC per head, dh0;
        # a, dtx, B, C, h0 -> y, h_out
        words = (a + 2 * x + 2 * bc + st + a + x + 2 * B * S * H * N + st
                 if backward else a + x + 2 * bc + st + x + st)
        flops = (ssd_ops.backward_flops if backward
                 else ssd_ops.forward_flops)(*shape)
    to = flops / F32_FLOPS_PER_S * 1e3
    tb = 4 * words / HBM_BYTES_PER_S * 1e3
    tc = 4 * (words + ck) / HBM_BYTES_PER_S * 1e3
    return {"bytes": 4 * words, "flops": flops, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "checkpoint_bytes": 4 * ck,
            "bound_with_checkpoints_ms": max(tc, to)}


def _errs(got, want, rtol: float, atol: float = 0.0) -> tuple[float, bool]:
    """(largest absolute error over the outputs, all within rtol of each
    output's largest entry plus atol)."""
    errs = [((g - w).abs().max().item(), w.abs().max().item())
            for g, w in zip(got, want)]
    return max(e for e, _ in errs), all(e <= rtol * m + atol
                                        for e, m in errs)


def scan_checks() -> list:
    """The four scan kernels against their plain versions on the card at
    ``scan_shapes()``, inputs from SEED (decays and gradients at the
    models' scales): forward with checkpoints, then the backward from the
    plain version's checkpoints, each output within the stated limits;
    the kernels timed in CUDA graphs (the forward without checkpoints, as
    prefill runs it, and with them, as training does), the plain versions
    with CUDA events."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.wkv6_scan import ops as wkv_ops
    from repro_torch.kernels.wkv6_scan import ref as wkv_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 23)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    shapes = scan_shapes()
    B, S, H, hd = shapes["wkv6"]
    wins = (n(B, S, H, hd), n(B, S, H, hd), n(B, S, H, hd),
            -torch.exp(n(B, S, H, hd) - 3), 0.1 * n(H, hd),
            n(B, H, hd, hd))
    wgrad = (n(B, S, H, hd), n(B, H, hd, hd))
    B, S, H, P, N = shapes["ssd"]
    sins = (-torch.nn.functional.softplus(n(B, S, H)),
            n(B, S, H, P), n(B, S, N), n(B, S, N), n(B, H, P, N))
    sgrad = (n(B, S, H, P), n(B, H, P, N))
    cases = (("wkv6", wins, wgrad, wkv_ops.wkv6_forward,
              wkv_ops.wkv6_backward, wkv_ref.wkv6_forward_ref,
              wkv_ref.wkv6_backward_ref, wkv_ref, 5,
              "src/repro/models/rwkv.py:141-152"),
             ("ssd", sins, sgrad, ssd_ops.ssd_forward, ssd_ops.ssd_backward,
              ssd_ref.ssd_forward_ref, ssd_ref.ssd_backward_ref, ssd_ref, 4,
              "src/repro/models/ssm.py:88-104"))
    out = []
    for kind, ins, grads, fwd, bwd, fwd_ref, bwd_ref, ref, n_in, at in cases:
        got = fwd(*ins, save=True)
        want = fwd_ref(*ins, save=True)
        f_err, f_ok = _errs(got, want, ref.FWD_RTOL, ref.FWD_ATOL)
        check(f_ok, f"{kind}_forward disagrees with its plain version: "
                    f"max abs err {f_err}")
        gk = bwd(*ins[:n_in], want[2], *grads)
        gp = bwd_ref(*ins[:n_in], want[2], *grads)
        b_err, b_ok = _errs(gk, gp, ref.GRAD_RTOL)
        check(b_ok, f"{kind}_backward disagrees with its plain version: "
                    f"max abs err {b_err}")
        del got, gk, gp
        shape = shapes[kind]
        fb, bb = scan_bound(kind, False, shape), scan_bound(kind, True, shape)
        ck = want[2]
        extra = scan_card_checks(kind, ins, grads, ck)
        out.append(dict(
            name=f"{kind}_forward", shape=shape, max_abs_err=f_err,
            tolerance={"rtol": ref.FWD_RTOL, "atol": ref.FWD_ATOL},
            ms=graph_ms(lambda: fwd(*ins)),
            ms_with_checkpoints=graph_ms(lambda: fwd(*ins, save=True)),
            plain_ms=device_ms(lambda: fwd_ref(*ins), reps=1),
            replaces=at, **extra.get("forward", {}), **fb))
        out.append(dict(
            name=f"{kind}_backward", shape=shape, max_abs_err=b_err,
            tolerance={"rtol": ref.GRAD_RTOL, "of": "each output's largest "
                                                    "entry"},
            ms=graph_ms(lambda: bwd(*ins[:n_in], ck, *grads)),
            plain_ms=device_ms(lambda: bwd_ref(*ins[:n_in], ck, *grads),
                               reps=1),
            replaces=at, **extra.get("backward", {}), **bb))
        del ins, grads, want, ck
        torch.cuda.empty_cache()
    return out


def scan_card_checks(kind: str, ins, grads, ck) -> dict:
    """The scan kernels of ``kind`` ("wkv6" or "ssd") at their layer shape,
    beyond the check against the plain versions: a second run on the same
    inputs equal bit for bit (no atomics); a run of 40 tokens whose decay is
    exactly 0 (log decay -200: exp underflows) and one of 40 whose decay is
    1 (log decay 0), and for RWKV-6 one of 100 tokens of strong decays (log
    decay down to -20 a token, where folding the decay into r and k over a
    chunk overflows), finite and within the limits of the plain versions;
    and each call's kernels, grids and threads as the launcher reports them
    (``last_plan`` of the timed calls; the profiler must see those kernels
    and no other).  {"forward": {...}, "backward": {...}}, each with
    ``repeat_bitwise``, ``zero_decay_err``, ``plan`` and ``kernel_ms``."""
    if kind == "wkv6":
        from repro_torch.kernels.wkv6_scan import ops, ref
        fwd, bwd = ops.wkv6_forward, ops.wkv6_backward
        fwd_ref, bwd_ref = ref.wkv6_forward_ref, ref.wkv6_backward_ref
        at, n_in = 3, 5
    else:
        from repro_torch.kernels.ssd_scan import ops, ref
        fwd, bwd = ops.ssd_forward, ops.ssd_backward
        fwd_ref, bwd_ref = ref.ssd_forward_ref, ref.ssd_backward_ref
        at, n_in = 0, 4
    f1, f2 = fwd(*ins, save=True), fwd(*ins, save=True)
    b1 = bwd(*ins[:n_in], ck, *grads)
    b2 = bwd(*ins[:n_in], ck, *grads)
    same_f = all(torch.equal(x, y) for x, y in zip(f1, f2))
    same_b = all(torch.equal(x, y) for x, y in zip(b1, b2))
    check(same_f and same_b, f"{kind} kernels differ between two runs: "
                             f"forward {same_f}, backward {same_b}")
    del f1, f2, b1, b2
    lz = ins[at].clone()
    lz[:, 1000:1040] = -200.0
    lz[:, 2000:2040] = 0.0
    if kind == "wkv6":
        g = torch.Generator(device="cuda").manual_seed(SEED + 24)
        lz[:, 3000:3100] = -20.0 * torch.rand(lz[:, 3000:3100].shape,
                                              generator=g, device="cuda")
    zins = (*ins[:at], lz, *ins[at + 1:])
    got = fwd(*zins, save=True)
    want = fwd_ref(*zins, save=True)
    f_err, f_ok = _errs(got, want, ref.FWD_RTOL, ref.FWD_ATOL)
    gk = bwd(*zins[:n_in], want[2], *grads)
    gp = bwd_ref(*zins[:n_in], want[2], *grads)
    b_err, b_ok = _errs(gk, gp, ref.GRAD_RTOL)
    finite = all(bool(torch.isfinite(t).all()) for t in (*got, *gk))
    check(finite and f_ok and b_ok,
          f"{kind} kernels on decays of 0 and 1: finite {finite}, forward "
          f"err {f_err}, backward err {b_err}")
    del got, want, gk, gp
    out = {}
    for way, wrapper, call in (
            ("forward", fwd, lambda: fwd(*ins)),
            ("backward", bwd, lambda: bwd(*ins[:n_in], ck, *grads))):
        wrapper.last_plan = None
        kernel_ms = scan_kernel_ms(call, kind)
        plan = wrapper.last_plan
        check(plan is not None and set(plan["grids"]) == set(kernel_ms),
              f"{kind}_{way}: the launcher's plan {plan} does not name the "
              f"kernels the profiler saw, {sorted(kernel_ms)}")
        out[way] = {"repeat_bitwise": same_f if way == "forward" else same_b,
                    "zero_decay_err": f_err if way == "forward" else b_err,
                    "plan": plan, "kernel_ms": kernel_ms}
    return out


def scan_kernel_ms(call, kind: str, reps: int = 10) -> dict:
    """Device ms of each kernel one call of a scan wrapper of ``kind`` runs,
    from torch.profiler's raw events over ``reps`` calls after a warm
    one."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out: dict = {}
    for name, (_, ms) in kernel_rows(prof).items():
        short = re.search(rf"({kind}_\w+(?:<\w+>)?)\(", name)
        if short:
            out[short.group(1)] = out.get(short.group(1), 0.0) + ms / reps
    return out


def long_prefill_reduced(arch: str) -> dict:
    """The long prefill's cuts: {what: [published, run]}."""
    from repro_torch.models.config import PREFILL_32K

    return {"global_batch": [PREFILL_32K.global_batch, 1],
            "seq_len": [PREFILL_32K.seq_len, LONG_PREFILL_LEN]}


@contextlib.contextmanager
def plain_scans():
    """The models' scans through the plain per-token loops (``ref.py``) on
    the card: the yardstick the kernels' main path is held against."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.wkv6_scan import ops as wkv_ops
    from repro_torch.kernels.wkv6_scan import ref as wkv_ref

    saved = wkv_ops.wkv6_scan, ssd_ops.ssd_scan
    wkv_ops.wkv6_scan = lambda *a: wkv_ref.wkv6_forward_ref(*a)[:2]
    ssd_ops.ssd_scan = lambda *a: ssd_ref.ssd_forward_ref(*a)[:2]
    try:
        yield
    finally:
        wkv_ops.wkv6_scan, ssd_ops.ssd_scan = saved


def _sealed_prefill_cell(arch: str, dtype: str):
    """prefill_32k's cell of ``arch`` with its weights and activations in
    ``dtype`` (the configs' ``dtype`` and ``param_dtype``), the weights
    from SEED, sealed, and the LONG_PREFILL_LEN-token prompt from SEED + 5:
    (cell, sealed weights, prompt)."""
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.launch import steps

    cell = steps.make_cell(arch, "prefill_32k",
                           overrides={"dtype": dtype, "param_dtype": dtype})
    cfg = cell.cfg
    params = cell.model.init(torch.Generator(device="cuda").manual_seed(SEED),
                             cfg, "cuda")
    sealed = sealed_lib.seal_tree(params, cell.key, cell.sec.weights, 1 << 8)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tokens = torch.randint(0, cfg.vocab, (1, LONG_PREFILL_LEN), generator=g,
                           device="cuda", dtype=torch.int32)
    return cell, sealed, tokens


def _prefill_fn(cell, n_tok: int):
    import dataclasses

    from repro_torch.launch import steps

    cell.shape = dataclasses.replace(cell.shape, seq_len=n_tok,
                                     global_batch=1)
    return steps.make_prefill_fn(cell)


def _against_plain_loops(arch, dtype, prefill, sealed, tokens,
                         logits) -> dict:
    """The same prefill of LONG_PREFILL_CHECK tokens through the plain
    loops: its last-token logits' largest difference from ``logits`` (the
    kernels'), held to PREFILL_LOGIT_TOL."""
    with plain_scans():
        t1 = time.perf_counter()
        plain, _ = prefill(sealed, {"tokens": tokens[:, :LONG_PREFILL_CHECK]})
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
    diff = (logits.float() - plain.float()).abs().max().item()
    limit = PREFILL_LOGIT_TOL[dtype][arch]
    check(diff <= limit, f"{arch}: {dtype} prefill logits through the "
                         f"kernels differ from the plain loops' by {diff} "
                         f"(limit {limit})")
    return {"diff": diff, "limit": limit, "plain_wall_s": plain_s}


def long_prefill_phase(arch: str) -> dict:
    """One prompt of LONG_PREFILL_LEN tokens sealed through
    ``steps.make_prefill_fn`` (full-size weights from SEED, sealed; the
    decode state sealed): wall time, peak memory and launches (one scan
    forward a layer, no backward); finite last-token logits.  Then at
    LONG_PREFILL_CHECK tokens the logits through the kernels against the
    plain loops' on the card, within PREFILL_LOGIT_TOL: as published
    (bfloat16), and with weights and activations in float32."""
    t0 = time.perf_counter()
    cell, sealed, tokens = _sealed_prefill_cell(arch, "bfloat16")
    cfg = cell.cfg
    setup_s = time.perf_counter() - t0
    out = {"arch": arch, "setup_s": setup_s,
           "reduced": long_prefill_reduced(arch)}
    want = {k: (cfg.n_layers if k.endswith("forward") else 0)
            for k in scan_launches_per_step(cfg)}
    for n_tok in (LONG_PREFILL_LEN, LONG_PREFILL_CHECK):
        prefill = _prefill_fn(cell, n_tok)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t1 = time.perf_counter()
        logits, state = prefill(sealed, {"tokens": tokens[:, :n_tok]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = read_launches()
        finite = bool(torch.isfinite(logits).all())
        check(tuple(logits.shape) == (1, cfg.vocab) and finite,
              f"{arch}: prefill of {n_tok} tokens gave logits "
              f"{tuple(logits.shape)}, finite {finite}")
        check({k: launches[k] for k in want} == want,
              f"{arch}: prefill of {n_tok} tokens launched {launches}")
        check(launches["ctr_cipher"] > 0 and launches["tree_mac"] > 0
              and "nonce" in state,
              f"{arch}: prefill of {n_tok} tokens did not run sealed")
        out[n_tok] = {"wall_s": wall, "launches": launches,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
        del state
    out["logits"] = {"bfloat16": _against_plain_loops(
        arch, "bfloat16", prefill, sealed, tokens, logits)}
    del sealed, tokens, logits
    cell, sealed, tokens = _sealed_prefill_cell(arch, "float32")
    prefill = _prefill_fn(cell, LONG_PREFILL_CHECK)
    logits, _ = prefill(sealed, {"tokens": tokens[:, :LONG_PREFILL_CHECK]})
    out["logits"]["float32"] = _against_plain_loops(
        arch, "float32", prefill, sealed, tokens, logits)
    del sealed, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def print_long_prefill(f: dict, card: str) -> None:
    arch, n, m = f["arch"], LONG_PREFILL_LEN, LONG_PREFILL_CHECK
    r, c = f[n], f[m]
    print(f"long-prefill {arch}: {n} tokens sealed in {r['wall_s']:.3f} s = "
          f"{n / r['wall_s']:.0f} tok/s, peak memory "
          f"{r['peak_bytes'] / 2**30:.2f} GiB, launches "
          f"{json.dumps(r['launches'])}; set-up {f['setup_s']:.1f} s; "
          f"reduced {json.dumps(f['reduced'])}; {card}", flush=True)
    diffs = "; ".join(
        f"{dt} {d['diff']:.4g} (limit {d['limit']}; plain loops "
        f"{d['plain_wall_s']:.3f} s)" for dt, d in f["logits"].items())
    print(f"long-prefill {arch}: {m} tokens in {c['wall_s']:.3f} s through "
          f"the kernels; last-token logits max abs diff from the plain "
          f"loops' {diffs}; {card}", flush=True)


def print_scan_checks(cases: list, card: str) -> None:
    for c in cases:
        ck = (f"; with checkpoints {c['ms_with_checkpoints']:.4f} ms"
              if "ms_with_checkpoints" in c else "; reading checkpoints")
        print(f"check {c['name']} {list(c['shape'])}: max abs err "
              f"{c['max_abs_err']:.3g} (limit {json.dumps(c['tolerance'])}),"
              f" kernel {c['ms']:.4f} ms in a CUDA graph, plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}: {c['bytes']} bytes, {c['flops']} FLOPs)"
              f"{ck}: + {c['checkpoint_bytes']} checkpoint bytes, bound "
              f"{c['bound_with_checkpoints_ms']:.4f} ms; {card}",
              flush=True)
        if "plan" in c:
            print(f"{c['name'].split('_')[0]} plan {c['name']}: "
                  f"{json.dumps(c['plan'])}; device "
                  f"ms a call by kernel {json.dumps(c['kernel_ms'])}; kernel "
                  f"{c['ms']:.4f} ms against bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_ms'] / c['ms']:.1%}); two runs bit for bit "
                  f"{c['repeat_bitwise']}; 40 decays of 0 and 40 of 1"
                  f"{', 100 strong' if c['name'].startswith('wkv6') else ''}"
                  f": max abs err {c['zero_decay_err']:.3g}; {card}",
                  flush=True)


# the fused causal attention's shapes: granite-3-2b's training layer (B 1,
# S 4096, 32 query and 8 KV heads of 64) and its serving prefill chunk (the
# engine's 32 lanes, S 512 over T 2048 + 512 cached rows; lanes resume at
# 0, 512, 1024 and 1536 in turn, as 1-4-chunk prompts do)
FLASH_SHAPES = {"train": (1, 4096, 4096, 8, 4, 64),
                "prefill": (32, 512, 2560, 8, 4, 64)}
FLASH_PREFILL_BASES = (0, 512, 1024, 1536)


def flash_pairs(B: int, S: int, T: int, bases) -> int:
    """Visible (query, key) pairs of one head summed over the lanes."""
    return sum(min(T, b + s + 1) for b in bases[:B] for s in range(S))


def flash_bound(B, S, T, K, G, hd, bases, backward: bool) -> dict:
    """Least time of the causal attention's own products at the bf16
    tensor-core rate: 4 hd FLOPs a visible pair forward (q k^T, P v), 8 hd
    backward (dP, dV, dK, dQ); the recompute of S and the split's second
    products are the kernels' extra work and not counted."""
    flops = (8 if backward else 4) * hd * K * G * flash_pairs(B, S, T, bases)
    return {"flops": flops, "bound_ms": flops / BF16_FLOPS_PER_S * 1e3}


def flash_checks() -> list:
    """The fused attention kernels against their plain version (ref.py) at
    FLASH_SHAPES, inputs from SEED: forward and backward within the limits
    of tests/test_torch_flash_attention.py, two runs equal bit for bit;
    timed with CUDA events beside their bound, the plain version, the
    float32 chain gqa_attention ran before (``_attend_block`` over blocks of
    512 queries, TF32 on its bf16 logits, autograd for its backward) and
    ``scaled_dot_product_attention`` (a yardstick the port never calls);
    each kernel's share from the profiler; peak memory over a forward and
    backward against the chain's."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import layers

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    out = []
    for kind, (B, S, T, K, G, hd) in FLASH_SHAPES.items():
        H = K * G
        bases = ([FLASH_PREFILL_BASES[b % 4] for b in range(B)]
                 if kind == "prefill" else [0] * B)

        def n(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()

        q, k, v, dout = n(B, S, H, hd), n(B, T, K, hd), n(B, T, K, hd), \
            n(B, S, H, hd)
        base = (torch.tensor(bases, dtype=torch.int32, device="cuda")
                if kind == "prefill" else None)
        bp = base if base is not None else 0
        o, o32, lse = fa_ops.flash_forward(q, k, v, base)
        ro, r32, rl = fa_ref.forward(q, k, v, base)
        vmax = v.float().abs().max().item()
        f_err = (o32 - r32).abs().max().item()
        o_ok = bool(((o.float() - r32).abs()
                     <= 2 ** -8 * r32.abs() + 2 ** -16 * vmax).all())
        check(f_err <= 2 ** -16 * vmax and o_ok,
              f"flash forward ({kind}) disagrees with its plain version: "
              f"float32 output off by {f_err}, bf16 within limits {o_ok}")
        lse_err = (lse - rl).abs().max().item()
        check(lse_err <= 1e-5 * rl.abs().max().item(),
              f"flash log-sum-exp ({kind}) off by {lse_err}")
        got = fa_ops.flash_backward(q, k, v, base, o32, lse, dout)
        want = fa_ref.backward(q, k, v, base, r32, rl, dout)
        b_err = max(((x.float() - w).abs()
                     - 2 ** -8 * w.abs()).max().item()
                    / w.abs().max().item() for x, w in zip(got, want))
        check(b_err <= 2 ** -14, f"flash backward ({kind}) disagrees with "
                                 f"its plain version: {b_err}")
        del ro, r32, rl, want
        o2 = fa_ops.flash_forward(q, k, v, base)
        got2 = fa_ops.flash_backward(q, k, v, base, o32, lse, dout)
        same = (all(torch.equal(x, y) for x, y in zip((o, o32, lse), o2))
                and all(torch.equal(x, y) for x, y in zip(got, got2)))
        check(same, f"flash kernels ({kind}) differ between two runs")
        del o2, got, got2
        torch.cuda.empty_cache()

        def chain_fwd():
            with torch.no_grad():
                return layers.gqa_attention(q.float(), k.float(), v.float(),
                                            causal=True, base_pos=bp)

        def sdpa():
            qh = q.transpose(1, 2)
            kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
            vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
            if base is None:
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True)
            pos = base[:, None] + torch.arange(S, device="cuda")
            mask = torch.arange(T, device="cuda") <= pos[..., None]
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask[:, None])

        fwd_ms = device_ms(lambda: fa_ops.flash_forward(q, k, v, base))
        fwd_kernels = scan_kernel_ms(lambda: fa_ops.flash_forward(q, k, v,
                                                                  base),
                                     "flash_attn")
        row = {"name": "flash_forward", "shape": kind,
               "dims": [B, S, T, K, G, hd], "max_abs_err": f_err,
               "ms": fwd_ms, "kernel_ms": fwd_kernels,
               "plain_ms": device_ms(lambda: fa_ref.forward(q, k, v, base),
                                     reps=2),
               "chain_ms": device_ms(chain_fwd, reps=3),
               "library_ms": device_ms(sdpa, reps=5), "repeat_bitwise": same,
               **flash_bound(B, S, T, K, G, hd, bases, False)}
        out.append(row)
        if kind == "train":
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))

            def chain_step():
                x = layers.gqa_attention(qq.float(), kk.float(), vv.float(),
                                         causal=True)
                x.backward(dout.float())

            def fused_step():
                fa_ops.flash_attention(qq, kk, vv).backward(dout)

            def peak(step):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                step()
                torch.cuda.synchronize()
                return torch.cuda.max_memory_allocated() - before

            bwd_ms = device_ms(lambda: fa_ops.flash_backward(
                q, k, v, base, o32, lse, dout))
            bwd_kernels = scan_kernel_ms(lambda: fa_ops.flash_backward(
                q, k, v, base, o32, lse, dout), "flash_attn")
            out.append({
                "name": "flash_backward", "shape": kind,
                "dims": [B, S, T, K, G, hd], "max_abs_err": b_err,
                "ms": bwd_ms, "kernel_ms": bwd_kernels,
                "plain_ms": device_ms(lambda: fa_ref.backward(
                    q, k, v, base, o32, lse, dout), reps=2),
                "chain_ms": device_ms(chain_step, reps=3)
                - row["chain_ms"],
                "library_ms": device_ms(
                    lambda: sdpa_backward(sdpa, q, k, v, dout), reps=5)
                - row["library_ms"],
                "repeat_bitwise": same,
                "peak_bytes": {"fused": peak(fused_step),
                               "chain": peak(chain_step)},
                **flash_bound(B, S, T, K, G, hd, bases, True)})
        del q, k, v, dout, o, o32, lse
        torch.cuda.empty_cache()
    return out


def sdpa_backward(sdpa, q, k, v, dout):
    """``sdpa``'s forward and backward over leaves made from q, k, v."""
    for t in (q, k, v):
        t.requires_grad_(True)
    try:
        sdpa().backward(dout.transpose(1, 2))
    finally:
        for t in (q, k, v):
            t.requires_grad_(False)
            t.grad = None


def print_flash_checks(rows: list, card: str) -> None:
    for c in rows:
        extra = (f"; peak bytes of a forward and backward: fused "
                 f"{c['peak_bytes']['fused']}, float32 chain "
                 f"{c['peak_bytes']['chain']}" if "peak_bytes" in c else "")
        print(f"check {c['name']} {c['shape']} {c['dims']}: max err "
              f"{c['max_abs_err']:.3g}; kernel {c['ms']:.4f} ms (CUDA "
              f"events), by kernel {json.dumps(c['kernel_ms'])}; bound "
              f"{c['bound_ms']:.4f} ms ({c['flops']} FLOPs at the bf16 "
              f"rate, {c['bound_ms'] / c['ms']:.1%}); plain "
              f"{c['plain_ms']:.2f} ms; float32 chain {c['chain_ms']:.2f} "
              f"ms; sdpa {c['library_ms']:.4f} ms; two runs bit for bit "
              f"{c['repeat_bitwise']}{extra}; {card}", flush=True)


def ctr_payload_bound(shape, dtype) -> dict:
    """Bytes, ALU operations and bound of one CTR pass over a payload (read
    and write every byte; one Threefry block a row's two words, bytes
    padded to whole words a row)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    last = shape[-1] if shape else 1
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    words = -(-last * itemsize // 4)
    blocks = rows * ((words + 1) // 2)
    nbytes = 2 * int(np.prod(shape)) * itemsize
    ms, by = bound_of(nbytes, blocks * CTR_ALU_OPS_PER_BLOCK)
    return {"bytes": nbytes, "alu_ops": blocks * CTR_ALU_OPS_PER_BLOCK,
            "bound_ms": ms, "bound_by": by}


def payload_seal(tree: dict, key, quantize: bool) -> dict:
    """One pod's seal of a cross-pod gradient payload through the CTR
    kernel (each leaf in a CUDA graph; int8 values and f32 block scales
    when quantizing) against its bound: {ms, bytes, alu_ops, bound_ms,
    bound_by}."""
    import torch.nn.functional as F

    from repro_torch.core import cipher
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.parallel import compress

    tkeys = cipher.derive_tensor_key(key.reshape(1, 2), 7)
    ms = 0.0
    bound = {"bytes": 0, "alu_ops": 0}
    for x in tree.values():
        parts = list(compress.quantize_int8(x)) if quantize else [x]
        for p in parts:
            raw = p.contiguous().view(cipher.uint_dtype_for(p.dtype))
            if raw.element_size() == 1:
                raw = F.pad(raw, (0, (-raw.shape[-1]) % 4)
                            ).contiguous().view(torch.int32)
            x3 = raw.reshape(1, -1, raw.shape[-1])
            ms += graph_ms(lambda x3=x3: ctr_ops.ctr_xor(x3, tkeys), reps=3)
            b = ctr_payload_bound(tuple(p.shape), p.dtype)
            bound["bytes"] += b["bytes"]
            bound["alu_ops"] += b["alu_ops"]
            del raw, x3
        del parts
    bms, by = bound_of(bound["bytes"], bound["alu_ops"])
    return {"ms": ms, **bound, "bound_ms": bms, "bound_by": by}


def crosspod_check(grads, key) -> dict:
    """``make_crosspod_grad_hook`` over one step's gradients in a one-process
    NCCL group: with one pod the hook seals, gathers, unseals and divides
    by 1, so quantize off must return the gradients bit for bit and
    quantize on within half an int8 step of each block's scale.  Each mode:
    the hook's wall time and launches, and one pod's seal of the payload
    through the CTR kernel (each leaf in a CUDA graph) against its bound."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives, compress

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        tree = {f"{i:03d}": g.to("cuda") for i, g in enumerate(grads)}
        payload_bytes = sum(g.numel() * g.element_size()
                            for g in tree.values())
        for quantize in (False, True):
            hook = collectives.make_crosspod_grad_hook(key, 1,
                                                       quantize=quantize)
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = hook(tree, torch.tensor(TRAIN_FAMILY_STEPS + 1))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            worst = 0.0
            for k, x in tree.items():
                if quantize:
                    _, scale = compress.quantize_int8(x)
                    lim = scale.repeat_interleave(compress.BLOCK)[
                        :x.numel()] / 2
                    err = (got[k] - x).abs().reshape(-1)
                    worst = max(worst, float((err / lim).max()))
                else:
                    check(torch.equal(got[k].view(torch.int32),
                                      x.view(torch.int32)),
                          f"crosspod hook changed leaf {k}")
            check(worst <= 1 + 1e-4, f"crosspod int8 error {worst} steps")
            del got
            seal = payload_seal(tree, key, quantize)
            out["int8" if quantize else "f32"] = dict(
                wall_ms=wall_ms, launches=launches, ctr_ms=seal["ms"],
                ctr_bound_ms=seal["bound_ms"], bound_by=seal["bound_by"],
                ctr_bytes=seal["bytes"],
                worst_int8_steps=worst if quantize else None)
        out["payload_bytes"] = payload_bytes
        out["leaves"] = len(tree)
    finally:
        dist.destroy_process_group()
        del tree
        torch.cuda.empty_cache()
    return out


def smoke_train_families() -> dict:
    """Every ARCH_ID's SMOKE config: one sealed step through
    ``steps.make_cell`` / ``make_train_step_fn`` on the CPU and on the card
    from the same weights and batch (float32, TF32 off).  Per arch: the
    loss difference, the parameters' largest difference against lr, the
    share of entries off the CPU tests' one-step limit, and the card run's
    launches."""
    from repro_torch import configs
    from repro_torch.core.sealed import tree_leaves, tree_unflatten
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.train import seal_state, unseal_state_host

    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, smoke=True)
        params = registry.get_model(cfg).init(
            torch.Generator().manual_seed(SEED), cfg, "cpu")
        data = SyntheticLM(vocab=cfg.vocab, seq_len=SMOKE_TRAIN["seq"],
                           batch=SMOKE_TRAIN["batch"])
        mb = data.microbatches_at(0, SMOKE_TRAIN["accum"],
                                  steps.batch_extra(cfg, SMOKE_TRAIN["seq"]))
        res = {}
        for dev in ("cpu", "cuda"):
            cell = steps.make_cell(arch, "train_4k", smoke=True, device=dev)
            p = tree_unflatten(params, [x.to(dev)
                                        for x in tree_leaves(params)])
            state = seal_state(cell.opt.init(p), cell.key, cell.sec)
            zero_launches()
            state, m = steps.make_train_step_fn(cell)(
                state, {k: torch.as_tensor(v, device=dev)
                        for k, v in mb.items()})
            launches = read_launches()
            plain = unseal_state_host(state, cell.key, cell.sec)
            res[dev] = (float(m["loss"]), bool(m["seal_ok"]),
                        [x.float().cpu() for x in tree_leaves(plain.params)],
                        launches)
        (lc, okc, pc, _), (lg, okg, pg, launches) = res["cpu"], res["cuda"]
        lr = cell.opt.lr
        worst = off = total = 0
        for a0, a, b in zip(tree_leaves(params), pc, pg):
            dc, dg = a - a0.float(), b - a0.float()
            err = (dg - dc).abs()
            worst = max(worst, float(err.max()) / lr)
            off += int((err > 1e-3 * dc.abs() + 0.05 * lr).sum())
            total += err.numel()
        out[arch] = dict(loss_cpu=lc, loss_cuda=lg,
                         loss_rel=abs(lg - lc) / abs(lc), seal_ok=okc and okg,
                         worst_over_lr=worst, off_share=off / total,
                         launches=launches,
                         moments=configs.opt_state_dtype(arch),
                         acc=configs.acc_dtype(arch))
        r = out[arch]
        check(r["seal_ok"] and r["loss_rel"] <= 1e-4 and worst <= 2
              and r["off_share"] <= 1e-3,
              f"{arch} SMOKE step on the card differs from the CPU: {r}")
        check(launches["ctr_cipher"] > 0 and launches["tree_mac"] > 0,
              f"{arch} SMOKE step on the card launched {launches}")
    return out


def mac_path(row_bytes: int, cw: int) -> str:
    """The MAC kernel's path for rows of ``row_bytes`` at chunk width
    ``cw``, as ``mac_tags_launch`` in tree_mac.cu picks it."""
    if cw <= 8:
        return "small"
    if row_bytes % 4 == 0 and 32 <= cw <= 512 and not cw & (cw - 1):
        return "wide"
    return "general"


def leaf_cases(sealed, key):
    """(f) Every distinct (leaf shape, dtype, cw) of a sealed weight tree:
    the CTR and MAC kernels over the whole leaf against their plain
    versions bit for bit (the plain versions a slab of rows at a time,
    with the slab's counter rows and tag positions), each kernel's
    ``graph_ms`` and its bound.  ``count``: the leaves of the tree that
    share the case (a decode step unseals each once)."""
    from repro_torch.core import cipher, mac, sealed as sealed_lib
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops, ref as ctr_ref
    from repro_torch.kernels.tree_mac import ops as mac_ops, ref as mac_ref

    cases = {}
    for path, leaf in _tree_paths(sealed).items():
        e, isz = leaf.ct.shape[-1], leaf.ct.element_size()
        row_w = -(-e * isz // 4)
        cw = row_w // mac.chunk_count(row_w, leaf.spec.chunk_words)
        case_key = (tuple(leaf.ct.shape), leaf.ct.dtype, cw)
        if case_key in cases:
            cases[case_key]["count"] += 1
            continue
        x = leaf.ct.reshape(1, -1, e)
        R = x.shape[1]
        tkey = cipher.derive_tensor_key(key, leaf.nonce)[None].contiguous()
        mkeys = mac.mac_keys(mac.nonce_mac_key(key, leaf.nonce,
                                               leaf.spec.mac_domain), cw,
                             leaf.spec.mac_domain)[None]
        out = ctr_ops.ctr_xor(x, tkey)
        tags = mac_ops.mac_tags(x, mkeys)
        check(torch.equal(tags.reshape(leaf.tags.shape), leaf.tags),
              f"{path}: the MAC kernel's tags differ from the seal's")
        slab = max(1, SLAB_BYTES // (e * isz))
        ctr_bad = mac_bad = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r0 in range(0, R, slab):
            r1 = min(R, r0 + slab)
            rows = torch.arange(r0, r1, dtype=torch.int32,
                                device="cuda")[None]
            ctr_bad += int((out[:, r0:r1] != ctr_ref.ctr_xor_ref(
                x[:, r0:r1], tkey, rows)).sum())
            mac_bad += int((tags[:, r0:r1] != mac_ref.mac_tags_ref(
                x[:, r0:r1], mkeys, cw, row0=r0)).sum())
        plain_ms = (time.perf_counter() - t0) * 1e3
        del out, tags
        nbytes = x.numel() * isz
        ctr_b = bound_of(2 * nbytes,
                         R * ((row_w + 1) // 2) * CTR_ALU_OPS_PER_BLOCK)
        mac_b = bound_of(nbytes + R * (row_w // cw) * 4,
                         R * row_w * MAC_ALU_OPS_PER_WORD)
        cases[case_key] = dict(
            leaf=path, shape=list(leaf.ct.shape), dtype=str(leaf.ct.dtype),
            cw=cw, path=mac_path(e * isz, cw), count=1, bytes=nbytes,
            ctr_mismatches=ctr_bad, mac_mismatches=mac_bad,
            ctr_ms=graph_ms(lambda: ctr_ops.ctr_xor(x, tkey)),
            mac_ms=graph_ms(lambda: mac_ops.mac_tags(x, mkeys)),
            plain_ms=plain_ms, ctr_bound_ms=ctr_b[0], ctr_bound_by=ctr_b[1],
            mac_bound_ms=mac_b[0], mac_bound_by=mac_b[1])
        check(ctr_bad == 0 and mac_bad == 0,
              f"{path}: {ctr_bad} CTR and {mac_bad} MAC mismatches against "
              "the plain versions")
        torch.cuda.empty_cache()
    return list(cases.values())


def watch(eng):
    """Wrap a ServeEngine's prefill and decode: each call synchronized and
    timed, its logits (float32) and the kernel launches of each decode step
    recorded, the last state and token kept.  Returns the record."""
    rec = {}
    prefill, decode = eng._prefill, eng._decode

    def watched_prefill(params, batch, nonce):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(params, batch, nonce)
        torch.cuda.synchronize()
        rec.update(prefill_ms=(time.perf_counter() - t0) * 1e3, state=state,
                   logits=[logits.float()], decode_ms=[], steps=[])
        return logits, state

    def watched_decode(params, state, tokens):
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        logits, state = decode(params, state, tokens)
        torch.cuda.synchronize()
        rec["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        after = read_launches()
        rec["steps"].append({k: after[k] - before[k] for k in after})
        rec["logits"].append(logits.float())
        rec.update(state=state, tokens_in=tokens)
        return logits, state

    eng._prefill, eng._decode = watched_prefill, watched_decode
    rec["decode"] = decode
    return rec


def generate(eng, rec, batch) -> dict:
    """One greedy generation with the launch counts zeroed just before it:
    tokens, wall time, launches, and the record's per-call data."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    tokens = eng.generate(batch, FAMILY_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = tokens.size
    return dict(tokens=tokens, wall=wall, tok_per_s=n_tok / wall,
                launches=read_launches(), prefill_ms=rec["prefill_ms"],
                decode_ms=statistics.median(rec["decode_ms"]),
                steps=list(rec["steps"]), logits=list(rec["logits"]))


def fused_attention_check(cfg, cache, kv_key, n_tokens):
    """qwen3-4b's fused decode: the sealed-attention kernel against its
    plain version at B 4, K 8, G 4, hd 128, T = max_len (random q, K and
    V sealed by ``ops.seal_cache``, t_valid the served length and T; verify
    off and on; then layer 0 of the fused run's own cache), within two
    bf16 ulps; graph_ms and the bound of one layer's call."""
    from repro_torch.core import cipher, mac
    from repro_torch.kernels.sealed_attention import ops as sa_ops
    from repro_torch.kernels.sealed_attention import ref as sa_ref
    from repro_torch.models import transformer

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    B, T, K, hd = cache["k_ct"].shape[1:]
    G = cfg.n_heads // K
    q = torch.randn((B, K, G, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, T, K, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, T, K, hd), generator=g, device="cuda").bfloat16()
    master = torch.randint(-2**31, 2**31 - 1, (2,), generator=g,
                           device="cuda", dtype=torch.int64).to(torch.int32)
    k_ct, v_ct, k_tags, v_tags = sa_ops.seal_cache(k, v, master, 31, 32)
    keys = (cipher.derive_tensor_key(master, 31),
            cipher.derive_tensor_key(master, 32),
            mac.mac_keys(mac.nonce_mac_key(master, 31), hd // 2))
    cases = []
    for tv in (n_tokens, T):
        for verify in (False, True):
            args = (q, k_ct, v_ct, k_tags, v_tags, *keys, tv)
            out, bad = sa_ops.sealed_decode_attention(*args, verify=verify)
            want, want_bad = sa_ref.sealed_decode_attention_words_ref(
                *args, verify)
            excess = sa_ref.out_excess(out, want)
            err = (out.float() - want.float()).abs().max().item()
            name = f"B {B}, T {T}, K {K}, G {G}, hd {hd}, t_valid {tv}, " \
                   f"verify {verify}"
            check(excess <= 0 and torch.equal(bad, want_bad)
                  and not bad.any(), f"sealed_attention off by {err} at {name}")
            cases.append(dict(shape=name, max_abs_err=err, excess=excess))
    # layer 0 of the fused run's cache, as the fused decode reads it
    nk, nv = transformer._kv_nonces(cache["nonce"], 0)
    tval = int(cache["pos"])
    args = (q, cache["k_ct"][0], cache["v_ct"][0], None, None,
            cipher.derive_tensor_key(kv_key, nk),
            cipher.derive_tensor_key(kv_key, nv), None, tval)
    out, _ = sa_ops.sealed_decode_attention(*args, verify=False)
    want, _ = sa_ref.sealed_decode_attention_words_ref(*args, False)
    err = (out.float() - want.float()).abs().max().item()
    check(sa_ref.out_excess(out, want) <= 0,
          f"sealed_attention off by {err} on the fused run's cache")
    cases.append(dict(shape=f"layer 0 of the fused run, t_valid {tval}",
                      max_abs_err=err,
                      excess=sa_ref.out_excess(out, want)))
    layer = dict(t_valid=tval,
                 ms=graph_ms(lambda: sa_ops.sealed_decode_attention(
                     *args, verify=False)),
                 plain_ms=device_ms(
                     lambda: sa_ref.sealed_decode_attention_words_ref(
                         *args, False), reps=3),
                 **attention_bound(B, K, G, hd, tval, False))
    return cases, layer


def family_phase(arch: str, card: str) -> dict:
    """(f) One more configuration at its full published width and depth
    through the fixed-slot ServeEngine: random weights from a seeded
    torch.Generator on the card, served with security off; then the same
    weights sealed by the provider (plaintext freed), every distinct leaf
    case of the CTR and MAC kernels held against the plain versions, the
    sealed run (launch counts zeroed just before it), its tokens against
    the insecure run's, a flipped word of a sealed weight leaf poisoning
    every lane in one decode, and for qwen3-4b the fused decode."""
    from repro_torch import configs
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.core.channel import SecureChannel
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    published = configs.get_config(arch)
    cut = FAMILY_CUTS.get(arch, {})
    cfg = published.with_(**cut)
    reduced = {k: {"published": getattr(published, k), "run": v}
               for k, v in cut.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in _leaves(params))
    rng = np.random.RandomState(SEED + 11)
    batch = {"tokens": rng.randint(0, cfg.vocab, (FAMILY_B, FAMILY_PROMPT))
             .astype(np.int32)}
    n_front = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    if n_front:
        batch["patch_embeds"] = rng.standard_normal(
            (FAMILY_B, n_front, cfg.d_model)).astype(np.float32)
    n_frames = FAMILY_PROMPT if cfg.frontend == "frame" else 0
    if n_frames:
        batch["frame_embeds"] = rng.standard_normal(
            (FAMILY_B, n_frames, cfg.d_model)).astype(np.float32)
    max_len = n_front + FAMILY_PROMPT + FAMILY_NEW + 4

    eng = ServeEngine(cfg=cfg, params=params,
                      channel=SecureChannel.insecure(device="cuda"),
                      max_len=max_len)
    plain = generate(eng, watch(eng), batch)
    # the watched methods close over the engine's own bound methods, a
    # reference cycle: collect it, or its plaintext weights outlive it
    del eng
    gc.collect()
    provider = SecureChannel.establish(device="cuda")
    sealed = provider.upload_tree(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ct_bytes = sum(leaf.nbytes_ct for leaf in _leaves(sealed))
    tag_bytes = sum(leaf.nbytes_meta for leaf in _leaves(sealed))
    setup_s = time.perf_counter() - t0
    cases = leaf_cases(sealed, provider.jkey)

    eng = ServeEngine(cfg=cfg, params=sealed, channel=provider,
                      max_len=max_len)
    rec = watch(eng)
    torch.cuda.reset_peak_memory_stats()
    run = generate(eng, rec, batch)
    run["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(np.array_equal(run["tokens"], plain["tokens"]),
          f"{arch}: sealed tokens {run['tokens'].tolist()} differ from the "
          f"insecure run's {plain['tokens'].tolist()}")
    check(all(bool(torch.isfinite(x).all()) for x in run["logits"]),
          f"{arch}: the sealed run has non-finite logits")
    logit_diff = max((a - b).abs().max().item()
                     for a, b in zip(run["logits"], plain["logits"]))
    for s in run["steps"]:
        check(s["ctr_cipher"] > 0 and s["tree_mac"] > 0,
              f"{arch}: a sealed decode step launched {s}")
    # a flipped word of a sealed weight leaf: one decode poisons every lane
    word = sealed_lib.tree_leaves(sealed)[0].ct.view(-1)
    word[word.numel() // 2] ^= 1 << 3
    bad, _ = rec["decode"](sealed, rec["state"], rec["tokens_in"])
    word[word.numel() // 2] ^= 1 << 3
    poisoned = bool(torch.isnan(bad).all())
    check(poisoned, f"{arch}: a flipped weight word left lanes unpoisoned")
    del bad, rec["state"]
    out = dict(arch=arch, card=card, params=n_params, ct_bytes=ct_bytes,
               tag_bytes=tag_bytes, setup_s=setup_s, max_len=max_len,
               n_front=n_front, n_frames=n_frames, reduced=reduced,
               plain=plain, sealed=run,
               logit_diff=logit_diff, cases=cases, poisoned=poisoned)
    if arch == "qwen3-4b":
        eng.cfg = cfg.with_(fused_sealed_attention=True)
        fused = generate(eng, rec, batch)
        check(np.array_equal(fused["tokens"][:, 0], plain["tokens"][:, 0]),
              "qwen3-4b: fused first tokens differ")
        check(all(s["sealed_attention"] == cfg.n_layers
                  for s in fused["steps"]),
              f"qwen3-4b: fused steps launched {fused['steps']}")
        fused["agreement"] = float((fused["tokens"] == plain["tokens"]).mean())
        fused["checks"], fused["layer"] = fused_attention_check(
            cfg, rec["state"], eng._kv_key, n_front + FAMILY_PROMPT)
        out["fused"] = fused
    for r in (out["plain"], out["sealed"], out.get("fused", {})):
        r.pop("logits", None)          # device tensors: free them here
    del eng, rec, sealed
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def step_sums(cases) -> dict:
    """One sealed decode step's unseal of the weight tree (every leaf once):
    CTR and MAC ms against their bounds, and the MAC general path's."""
    def total(key, sel=lambda c: True):
        return sum(c[key] * c["count"] for c in cases if sel(c))

    general = lambda c: c["path"] == "general"  # noqa: E731
    return dict(
        ctr_ms=total("ctr_ms"), ctr_bound_ms=total("ctr_bound_ms"),
        mac_ms=total("mac_ms"), mac_bound_ms=total("mac_bound_ms"),
        general_ms=total("mac_ms", general),
        general_bound_ms=total("mac_bound_ms", general),
        general_bytes=total("bytes", general), bytes=total("bytes"),
        plain_ms=total("plain_ms"))


def print_family(f: dict, card: str) -> None:
    """The families phase's lines for one configuration; adds its
    ``step`` sums to ``f``."""
    arch = f["arch"]
    for c in f["cases"]:
        print(f"family {arch} leaf {c['leaf']} {c['shape']} {c['dtype']}"
              f" (x{c['count']}): cw {c['cw']}, {c['path']} MAC path; "
              f"mismatches ctr {c['ctr_mismatches']} mac "
              f"{c['mac_mismatches']}; in a CUDA graph ctr "
              f"{c['ctr_ms']:.4f} ms (bound {c['ctr_bound_ms']:.4f}, "
              f"{c['ctr_bound_by']}), mac {c['mac_ms']:.4f} ms (bound "
              f"{c['mac_bound_ms']:.4f}, {c['mac_bound_by']}); plain "
              f"versions {c['plain_ms']:.1f} ms", flush=True)
    st = f["step"] = step_sums(f["cases"])
    general = (f"{st['general_ms']:.4f} ms against "
               f"{st['general_bound_ms']:.4f} over {st['general_bytes']} "
               f"bytes ({st['general_bound_ms'] / st['general_ms']:.1%} "
               "of its bound)" if st["general_ms"] else "no leaf")
    print(f"family {arch}: one decode step's weight unseal "
          f"({st['bytes']} ciphertext bytes): CTR {st['ctr_ms']:.4f} ms "
          f"against {st['ctr_bound_ms']:.4f} "
          f"({st['ctr_bound_ms'] / st['ctr_ms']:.1%}), MAC "
          f"{st['mac_ms']:.4f} ms against {st['mac_bound_ms']:.4f} "
          f"({st['mac_bound_ms'] / st['mac_ms']:.1%}); MAC general "
          f"path {general}; {card}", flush=True)
    for name in ("plain", "sealed", "fused"):
        r = f.get(name)
        if r is None:
            continue
        label = {"plain": "insecure", "sealed": "sealed",
                 "fused": "sealed fused"}[name]
        front = (f"{f['n_frames']} encoder frames, " if f["n_frames"]
                 else f"{f['n_front']} patch + ")
        print(f"family {arch} {label}: {FAMILY_B} lanes x {FAMILY_NEW} "
              f"tokens ({front}{FAMILY_PROMPT} prompt "
              f"positions, max_len {f['max_len']}) in {r['wall']:.3f} s "
              f"= {r['tok_per_s']:.2f} tok/s; prefill "
              f"{r['prefill_ms']:.1f} ms, decode {r['decode_ms']:.1f} ms "
              f"(median); launches a decode step "
              f"{json.dumps(r['steps'][0])}; run launches "
              f"{json.dumps(r['launches'])}"
              + (f"; peak memory {r['peak_bytes'] / 2**30:.2f} GiB"
                 if "peak_bytes" in r else "") + f"; {card}", flush=True)
    if f["reduced"]:
        print(f"family {arch}: reduced "
              + ", ".join(f"{k} {v['run']} of {v['published']}"
                          for k, v in f["reduced"].items())
              + " (full width)", flush=True)
    print(f"family {arch}: {f['params']} params, {f['ct_bytes']} "
          f"ciphertext + {f['tag_bytes']} tag bytes, set up in "
          f"{f['setup_s']:.1f} s; sealed tokens == insecure tokens, "
          f"largest logit difference {f['logit_diff']:.3g}; a flipped "
          f"weight word poisoned every lane; first tokens "
          f"{f['sealed']['tokens'][:, 0].tolist()}", flush=True)
    if "fused" in f:
        fu = f["fused"]
        for c in fu["checks"]:
            print(f"family {arch} check sealed_attention {c['shape']}: "
                  f"max abs err {c['max_abs_err']:.3g} (excess over two "
                  f"bf16 ulps {c['excess']:.3g})", flush=True)
        ly = fu["layer"]
        print(f"family {arch} fused: token agreement with the insecure "
              f"run {fu['agreement']:.4f} (first tokens equal); one "
              f"layer at t_valid {ly['t_valid']}: kernel "
              f"{ly['ms']:.4f} ms in a CUDA graph, plain "
              f"{ly['plain_ms']:.3f} ms, bound {ly['bound_ms']:.4f} ms "
              f"({ly['bound_by']}); {card}", flush=True)


def print_train_family(f: dict, card: str) -> None:
    arch, n = f["arch"], f["tokens_per_step"]
    for i, st in enumerate(f["steps"]):
        print(f"train-families {arch}: step {i} loss {st['loss']:.4f}, grad "
              f"norm {st['grad_norm']:.4f}, seal_ok {st['seal_ok']}, "
              f"{st['wall_s']:.3f} s = {n / st['wall_s']:.0f} tok/s, "
              f"launches ctr {st['ctr']} mac {st['mac']}"
              + (f" scans {json.dumps(st['scans'])}" if st.get("scans")
                 else ""), flush=True)
    p = f["profile"]
    print(f"train-families {arch}: {f['params']} params, sealed state "
          f"{f['sealed_bytes']} bytes, peak memory "
          f"{f['peak_bytes'] / 2**30:.2f} GiB, set-up {f['setup_s']:.1f} s, "
          f"remat {f['remat']}, moments {f['moments']}; launches "
          f"{json.dumps(f['launches'])}; reduced "
          f"{json.dumps(f['reduced'])}; a flipped mu bit poisoned the state;"
          f" {card}", flush=True)
    print(f"profile: one {arch} train step {p['wall_ms']:.1f} ms wall = "
          f"{n / p['wall_ms'] * 1e3:.0f} tok/s, {p['device_busy_ms']:.1f} ms "
          f"busy ({p['scans_ms']:.1f} ms of it the scans' kernels), idle "
          f"{p['device_idle_share']:.3f}, "
          f"{p['kernel_launches']} kernel rows (the profiler's own "
          f"processing {p.get('overhead_s', 0):.1f} s); top three "
          f"{json.dumps(p['top'])}", flush=True)


def parallel_reduced() -> dict:
    """The parallel phase's cuts: {part: {what: [published, run]}}."""
    from repro_torch import configs
    from repro_torch.models.config import TRAIN_4K

    moon = configs.get_config(PAR_EP_ARCH)
    return {"ep": {"n_layers": [moon.n_layers, PAR_EP_CUTS["n_layers"]],
                   "seq_len": [TRAIN_4K.seq_len, PAR_EP_SEQ],
                   "global_batch": [TRAIN_4K.global_batch, 1]},
            "pipeline": {"seq_len": [TRAIN_4K.seq_len, PAR_PP_SEQ],
                         "global_batch": [TRAIN_4K.global_batch,
                                          PAR_PP_MICRO],
                         "microbatch": [TRAIN_4K.microbatch, 1]}}


def sharded_reduced() -> dict:
    """The sharded train step's cuts of train_4k: {what: [published,
    run]}."""
    from repro_torch.models.config import TRAIN_4K

    return {"seq_len": [TRAIN_4K.seq_len, PAR_SH_SEQ],
            "global_batch": [TRAIN_4K.global_batch, PAR_SH_MICRO],
            "microbatch": [TRAIN_4K.microbatch, 1]}


def sharded_serve_reduced() -> dict:
    """The sharded serving cells' cuts: {shape: {what: [published,
    run]}}."""
    from repro_torch.models.config import DECODE_32K, PREFILL_32K

    return {"prefill_32k": {"seq_len": [PREFILL_32K.seq_len, PAR_SV_SLOTS],
                            "prompt_len": [PREFILL_32K.seq_len,
                                           PAR_SV_PROMPT],
                            "global_batch": [PREFILL_32K.global_batch,
                                             PAR_SV_BATCH]},
            "decode_32k": {"seq_len": [DECODE_32K.seq_len, PAR_SV_SLOTS],
                           "global_batch": [DECODE_32K.global_batch,
                                            PAR_SV_BATCH]}}


def _gloo_summary(step: dict) -> dict:
    """One sharded step's gloo collectives as {name: [calls, s, bytes]}."""
    return {name: [c["calls"], round(c["s"], 3), c["bytes"]]
            for name, c in step["collectives"].items()}


def print_parallel(par: dict, card: str) -> None:
    print(f"parallel: gloo operations on tensors on the card "
          f"{json.dumps(par['probe'])}; reduced from train_4k "
          f"{json.dumps(parallel_reduced())}; {card}", flush=True)
    for r in par["ranks"]:
        ep = r["ep"]
        print(f"parallel ep rank {r['rank']}: {PAR_EP_ARCH} at full width, "
              f"{PAR_EP_CUTS['n_layers']} layers, one sequence of "
              f"{PAR_EP_SEQ} tokens, mesh (data 1, model 2), "
              f"{ep['experts_held']} experts held; loss {ep['loss_ep']:.6f} "
              f"against the global dispatch's {ep['loss_global']:.6f} (rel "
              f"{ep['loss_rel']:.3g}, limit {PAR_EP_LOSS_RTOL}; bit for bit "
              f"{ep['loss_bits_equal']}); gradients within "
              f"{ep['grad_rel_max']:.3g} of each leaf's largest entry (limit "
              f"{PAR_EP_GRAD_RTOL}; worst {ep['grad_worst_leaf']}; "
              f"{ep['grad_leaves_exact']} of {ep['grad_leaves']} leaves bit "
              f"for bit); control without x's model-group gradient sum "
              f"{ep['control_grad_rel_max']:.3g}; forward and backward "
              f"{ep['wall_s_ep']:.3f} s (global {ep['wall_s_global']:.3f} "
              f"s); peak of the forward and backward "
              f"{ep['peak_bytes_ep'] / 2**30:.2f} GiB over "
              f"{ep['held_bytes_ep'] / 2**30:.2f} held before it (global "
              f"{ep['peak_bytes_global'] / 2**30:.2f} over "
              f"{ep['held_bytes_global'] / 2**30:.2f}); {card}",
              flush=True)
    hop, S, M = par["hop"], PAR_PP_STAGES, PAR_PP_MICRO
    for r in par["ranks"]:
        pp = r["pipeline"]
        print(f"parallel pipeline stage {pp['stage']}: {PAR_PP_ARCH}, {S} "
              f"stages, {M} microbatches of 1 x {PAR_PP_SEQ} tokens, sealed "
              f"hops; loss {pp['loss']:.6f} against the unpipelined "
              f"{pp['loss_unpipelined']:.6f} (rel {pp['loss_rel']:.3g}, "
              f"limit {PAR_PP_LOSS_RTOL}; bit for bit "
              f"{pp['loss_bits_equal']}); gradients within "
              f"{pp['grad_rel_max']:.3g} of each leaf's largest entry (limit "
              f"{PAR_PP_GRAD_RTOL}; worst {pp['grad_worst_leaf']}; "
              f"{pp['grad_leaves_exact']} of {pp['grad_leaves']} leaves bit "
              f"for bit); control unsealing the backward hop in domain 0 "
              f"{pp['control_grad_rel_max']:.3g}; step {pp['wall_s']:.3f} s "
              f"wall (unpipelined {pp['wall_s_unpipelined']:.3f} s); "
              f"launches {json.dumps(pp['launches'])}; peak "
              f"{pp['peak_bytes'] / 2**30:.2f} GiB; {card}", flush=True)
    print(f"parallel pipeline: {hop['bytes_per_tick']} bytes a hop a tick; "
          f"one hop's seal through the CTR kernel {hop['ms']:.4f} ms in a "
          f"CUDA graph against a {hop['bound_ms']:.4f} ms bound "
          f"({hop['bound_by']}), plain version {hop['plain_ms']:.3f} ms; "
          f"fill-drain bubble (S-1)/(M+S-1) = "
          f"{(S - 1) / (M + S - 1):.3f}; {card}", flush=True)
    for r in par["ranks"]:
        rs = r["restore"]
        print(f"parallel restore rank {r['rank']}: {PAR_PP_ARCH}'s sealed "
              f"parameters ({par['ckpt_bytes']} bytes of ciphertext and tags,"
              f" saved in {par['save_s']:.2f} s) onto make_smoke_mesh(2) by "
              f"params_shardings in {rs['wall_s']:.2f} s; {rs['leaves']} "
              f"leaves, {rs['blocks_sharded']} ct/tags blocks sharded, every "
              f"block equal bit for bit {rs['equal']}; {rs['bytes_held']} "
              f"bytes held; {card}", flush=True)
    print(f"parallel: phase {par['seconds']:.1f} s (mesh set-up "
          f"{max(r['mesh_s'] for r in par['ranks']):.1f} s a rank)",
          flush=True)


def print_sharded(par: dict, card: str) -> None:
    """One line a rank of the parallel phase's sharded sealed train
    step."""
    one = par["one_process"]
    for r in par["ranks"]:
        sh = r["sharded"]
        st = sh["steps"]
        print(f"sharded train rank {r['rank']}: {PAR_PP_ARCH} at full width"
              f" and depth, sealed state sharded over mesh (data 1, model 2),"
              f" {PAR_SH_MICRO} microbatches of 1 x {PAR_SH_SEQ} tokens a "
              f"step (reduced from train_4k "
              f"{json.dumps(sharded_reduced())}); step 0 loss "
              f"{st[0]['loss']:.6f} against one "
              f"process's {one['loss']:.6f} (abs diff "
              f"{abs(st[0]['loss'] - one['loss']):.3g}, limit "
              f"{PAR_SH_LOSS_ATOL}); losses {[x['loss'] for x in st]}; "
              f"seal_ok {[x['seal_ok'] for x in st]}; grad norm "
              f"{st[0]['grad_norm']:.6f} (one process "
              f"{one['grad_norm']:.6f}); steps "
              f"{[round(x['wall_s'], 3) for x in st]} s wall (one process "
              f"{one['wall_s']:.3f} s, peak "
              f"{one['peak_bytes'] / 2**30:.2f} GiB); launches a step (ctr, "
              f"mac) {[(x['ctr'], x['mac']) for x in st]}; peak "
              f"{sh['peak_bytes'] / 2**30:.2f} GiB; sealed bytes held "
              f"{sh['held_bytes']} of {sh['whole_bytes']}; blocks sealed in "
              f"{sh['build_s']:.2f} s; gloo a step [calls, s, bytes] "
              f"{json.dumps([_gloo_summary(x) for x in st])}; "
              f"a flipped bit in rank "
              f"{PAR_SH_TAMPER_RANK}'s block of "
              f"{'/'.join(PAR_SH_TAMPER_LEAF)}: seal_ok "
              f"{sh['tamper_seal_ok']}, state poisoned "
              f"{sh['tamper_poisoned']}; {card}", flush=True)


def print_sharded_serve(par: dict, card: str) -> None:
    """One line a rank of the parallel phase's sharded sealed serving, and
    one of the dry run's counts of its cells and of the sharded train
    step's beside the card's."""
    one = par["serve_one_process"]
    for r in par["ranks"]:
        sv = r["sharded_serve"]
        dec = sv["decode"]
        walls = [d["wall_s"] for d in dec]
        print(f"sharded serve rank {r['rank']}: {PAR_PP_ARCH} at full width "
              f"and depth, sealed parameters sharded over mesh (data 1, "
              f"model 2), {PAR_SV_BATCH} prompts of {PAR_SV_PROMPT} tokens "
              f"into a {PAR_SV_SLOTS}-slot sealed cache, {PAR_SV_STEPS} "
              f"greedy decode steps (reduced "
              f"{json.dumps(sharded_serve_reduced())}); prefill "
              f"{sv['prefill']['wall_s']:.3f} s (one process "
              f"{one['prefill_s']:.3f} s), decode {min(walls):.3f}-"
              f"{max(walls):.3f} s a step (one process "
              f"{min(one['decode_s']):.3f}-{max(one['decode_s']):.3f} s); "
              f"gloo [calls, s, bytes] prefill "
              f"{json.dumps(_gloo_summary(sv['prefill']))}, decode step 0 "
              f"{json.dumps(_gloo_summary(dec[0]))}; launches (ctr, mac) "
              f"prefill ({sv['prefill']['ctr']}, {sv['prefill']['mac']}), "
              f"a decode step {sorted({(d['ctr'], d['mac']) for d in dec})};"
              f" peak {sv['peak_bytes'] / 2**30:.2f} GiB (one process "
              f"{one['peak_bytes'] / 2**30:.2f}); sealed bytes held "
              f"{sv['held_bytes']} of {sv['whole_bytes']} (parameters and "
              f"cache); tokens equal to one process's {sv['tokens_equal']} "
              f"({PAR_SV_STEPS + 1} x {PAR_SV_BATCH}), largest logit "
              f"difference {sv['logit_diff']}; its cache block changed by "
              f"the decode steps {sv['block_changed']}; a flipped bit in rank"
              f" {PAR_SV_TAMPER_RANK}'s block of "
              f"{'/'.join(PAR_SH_TAMPER_LEAF)}: NaN logits "
              f"{sv['tamper_nan']}; {card}", flush=True)
    print(f"dry run against the card (launch/dryrun.py on the meta device, "
          f"fake group of 2, per call; [dry run, card]): "
          f"{json.dumps(par['dryrun_check'])}; dry run "
          f"{par['dryrun_s']:.1f} s; the parent held "
          f"{par['parent_reserved_bytes'] / 2**30:.2f} GiB of the card while "
          f"the ranks ran; {card}", flush=True)


def _counted():
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.sealed_attention import ops as sa_ops
    from repro_torch.kernels.sealed_matmul import ops as smm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.kernels.wkv6_scan import ops as wkv_ops
    return {"ctr_cipher": ctr_ops.ctr_xor, "tree_mac": mac_ops.mac_tags,
            "sealed_attention": sa_ops.sealed_decode_attention,
            "sealed_matmul": smm_ops.sealed_matmul,
            "wkv6_forward": wkv_ops.wkv6_forward,
            "wkv6_backward": wkv_ops.wkv6_backward,
            "ssd_forward": ssd_ops.ssd_forward,
            "ssd_backward": ssd_ops.ssd_backward,
            "flash_forward": fa_ops.flash_forward,
            "flash_backward": fa_ops.flash_backward}


def zero_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def smoke_reference():
    """The smoke config served on the card and on the CPU: same tokens."""
    from repro_torch import configs
    from repro_torch.core.channel import SecureChannel
    from repro_torch.core.policy import SecurityConfig
    from repro_torch.core.sealed import tree_leaves, tree_unflatten
    from repro_torch.models import transformer
    from repro_torch.serve.runner import Runner, Request
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.kv_pager import PagedKVPool

    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(SEED), cfg, "cpu")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 13, 20, 9)]
    keys = {"a": (1, 2), "b": (3, 4), "p": (5, 6)}
    outs = []
    for dev in ("cpu", "cuda"):
        ch = {t: SecureChannel(key_words=np.array(k, np.uint32),
                               key_bytes=bytes([i + 1]) * 32,
                               config=SecurityConfig(protect_launch=False),
                               session_id=40 + i, device=dev)
              for i, (t, k) in enumerate(keys.items())}
        p = tree_unflatten(params, [x.to(dev) for x in tree_leaves(params)])
        pool = PagedKVPool(n_pages=32, page_size=8, n_layers=cfg.n_layers,
                           n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                           dtype=cfg.act_dtype, device=dev)
        eng = PagedEngine(cfg=cfg, params=ch["p"].upload_tree(p),
                          channel=ch["p"], pool=pool, max_slots=4,
                          max_pages=5, prefill_chunk=16)
        reqs = [Request(i, "ab"[i % 2], pr, 12, ch["ab"[i % 2]])
                for i, pr in enumerate(prompts)]
        outs.append((Runner(eng, ch["p"]).run(reqs), dict(
            (k, pool.stats[k]) for k in pool.stats)))
    return outs


def moe_smoke_reference(arch: str = "llama4-maverick-400b-a17b"):
    """The SMOKE config served sealed through ServeEngine on the card and
    on the CPU (float32, TF32 off): tokens of each and the card run's
    launches.  llama4's pairs exercise moe_every 2 and the layer index of
    the decode slot's counter rows."""
    from repro_torch import configs
    from repro_torch.core.channel import SecureChannel
    from repro_torch.core.policy import SecurityConfig
    from repro_torch.core.sealed import tree_leaves, tree_unflatten
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get_config(arch, smoke=True)
    params = registry.get_model(cfg).init(
        torch.Generator().manual_seed(SEED), cfg, "cpu")
    rng = np.random.RandomState(SEED + 13)
    batch = {"tokens": rng.randint(0, cfg.vocab, (FAMILY_B, 12))
             .astype(np.int32)}
    outs = {}
    for dev in ("cpu", "cuda"):
        ch = SecureChannel(key_words=np.array([11, 12], np.uint32),
                           key_bytes=bytes(range(32)),
                           config=SecurityConfig(protect_launch=False),
                           session_id=70, device=dev)
        p = tree_unflatten(params, [x.to(dev) for x in tree_leaves(params)])
        eng = ServeEngine(cfg=cfg, params=ch.upload_tree(p), channel=ch,
                          max_len=12 + FAMILY_NEW + 4)
        zero_launches()
        outs[dev] = eng.generate(batch, FAMILY_NEW)
        torch.cuda.synchronize()
        outs[dev + "_launches"] = read_launches()
    return outs


# ---------------------------------------------------------------------------
# the parallel phase: two processes share the one card over gloo (NCCL
# refuses two ranks on one device)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_gloo(rank: int, port: int, timeout_s: float) -> None:
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _probe_op(op: str, rank: int) -> bool:
    """One collective on tensors on the card; True if the result is
    right."""
    import torch.distributed as dist
    dev, peer = torch.device("cuda", 0), 1 - rank
    t = torch.full((4,), float(rank + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(t)
        out, want = t, [3.0] * 4
    elif op == "broadcast":
        dist.broadcast(t, 0)
        out, want = t, [1.0] * 4
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, t)
        want = [1.0] * 4 + [2.0] * 4
    elif op == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, t)
        want = [3.0] * 2
    else:                                     # send_recv
        out = torch.empty(4, device=dev)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                         dist.P2POp(dist.irecv, out, peer)]):
            w.wait()
        want = [float(peer + 1)] * 4
    torch.cuda.synchronize()
    return out.tolist() == want


def _probe_rank(rank: int, port: int, out: str) -> None:
    """Each gloo operation of ``GLOO_PROBE_OPS`` on tensors on the card, in
    turn; the verdicts go to ``out`` as they come ("crashed" stands until
    the operation returns)."""
    import torch.distributed as dist
    _init_gloo(rank, port, 20)
    res = {}
    for op in GLOO_PROBE_OPS:
        res[op] = "crashed"
        Path(f"{out}.{rank}").write_text(json.dumps(res))
        try:
            res[op] = "ok" if _probe_op(op, rank) else "wrong result"
        except (RuntimeError, ValueError) as e:
            res[op] = f"refused: {type(e).__name__}: " \
                      f"{(str(e).splitlines() or [''])[0][:160]}"
        Path(f"{out}.{rank}").write_text(json.dumps(res))
    dist.destroy_process_group()


def gloo_cuda_probe() -> dict:
    """Which gloo operations take tensors on the card (torch's gloo backend
    runs some on CUDA tensors and not others), from two throwaway
    processes that may crash: {op: "ok" | "refused: ..." | "crashed" |
    "not reached"}."""
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    with tempfile.TemporaryDirectory(prefix="chip_smoke_probe_") as tmp:
        out = f"{tmp}/probe"
        ctx = mp.start_processes(_probe_rank, args=(_free_port(), out),
                                 nprocs=2, join=False, start_method="spawn")
        t_end = time.monotonic() + 180
        try:
            while not ctx.join(timeout=2) and time.monotonic() < t_end:
                pass
        except ProcessException:
            pass                              # recorded as "crashed"
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        res = [json.loads(Path(f"{out}.{r}").read_text())
               if Path(f"{out}.{r}").exists() else {} for r in range(2)]
    return {op: (res[0].get(op, "not reached")
                 if res[0].get(op) == res[1].get(op)
                 else f"rank 0: {res[0].get(op)}; rank 1: {res[1].get(op)}")
            for op in GLOO_PROBE_OPS}


def _fwd_bwd(params, loss_fn) -> tuple[float, float]:
    """(loss, wall s) of one forward and backward of ``loss_fn(params)``:
    the gradients land in the leaves' ``.grad``."""
    for leaf in _tree_paths(params).values():
        leaf.grad = None
        leaf.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn(params)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), time.perf_counter() - t0


def _rel_errs(grads: dict, ref: dict) -> dict:
    """Per leaf: max |g - ref| over max |ref| (inf where g is not
    finite)."""
    out = {}
    for path, r in ref.items():
        g = grads[path].float()
        r = r.to(g.device).float()
        if not bool(torch.isfinite(g).all()):
            out[path] = float("inf")
            continue
        scale = float(r.abs().max()) or 1.0
        out[path] = float((g - r).abs().max()) / scale
    return out


def _ep_rank(mesh) -> dict:
    """moonshot at full width, PAR_EP_CUTS: the global dispatch first (its
    loss and this rank's gradients kept on the host, its memory freed),
    then moe_ep with this model rank's 32 experts, then the control that
    drops the model-group sum of x's gradient."""
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import moe_ep
    from repro_torch.parallel import sharding as shd

    cell = steps.make_cell(PAR_EP_ARCH, "train_4k", security="off",
                           overrides=PAR_EP_CUTS)
    cfg, model = cell.cfg, cell.model
    e_l = cfg.moe.n_experts // mesh.size(mesh.mesh_dim_names.index("model"))
    e0 = mesh.get_local_rank("model") * e_l
    tok = torch.randint(0, cfg.vocab, (1, PAR_EP_SEQ), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(SEED + 1))
    batch = {"tokens": tok, "labels": tok}
    experts = {f"layers.moe.{n}" for n in ("w_gate", "w_up", "w_down")}

    def fresh():
        return model.init(torch.Generator(device="cuda").manual_seed(SEED),
                          cfg, "cuda")

    def grads(params):
        return {p: v.grad for p, v in _tree_paths(params).items()}

    params = fresh()
    held_g = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_g, wall_g = _fwd_bwd(params, lambda p: model.loss(p, cfg, batch))
    peak_g = torch.cuda.max_memory_allocated()
    ref = {p: (g[:, e0:e0 + e_l] if p in experts else g).cpu()
           for p, g in grads(params).items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    params = fresh()
    moe = params["layers"]["moe"]
    for n in ("w_gate", "w_up", "w_down"):
        moe[n] = moe[n][:, e0:e0 + e_l].clone()
    gc.collect()
    torch.cuda.empty_cache()
    ep_cfg = cfg.with_(moe_ep=True)
    with shd.use(shd.make_ctx(mesh)):
        held_e = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss_e, wall_e = _fwd_bwd(params,
                                  lambda p: model.loss(p, ep_cfg, batch))
        peak_e = torch.cuda.max_memory_allocated()
        errs = _rel_errs(grads(params), ref)
        keep = moe_ep._x_grad_groups
        moe_ep._x_grad_groups = lambda model_group, data_group: (data_group,)
        try:
            _fwd_bwd(params, lambda p: model.loss(p, ep_cfg, batch))
        finally:
            moe_ep._x_grad_groups = keep
        ctl = _rel_errs(grads(params), ref)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_global": loss_g, "loss_ep": loss_e,
            "loss_rel": abs(loss_e - loss_g) / abs(loss_g),
            "loss_bits_equal": (np.float32(loss_e).view(np.uint32)
                                == np.float32(loss_g).view(np.uint32)).item(),
            "grad_rel_max": max(errs.values()),
            "grad_worst_leaf": max(errs, key=errs.get),
            "grad_leaves_exact": sum(v == 0 for v in errs.values()),
            "grad_leaves": len(errs),
            "control_grad_rel_max": max(ctl.values()),
            "experts_held": e_l, "wall_s_global": wall_g, "wall_s_ep": wall_e,
            "peak_bytes_global": peak_g, "peak_bytes_ep": peak_e,
            "held_bytes_global": held_g, "held_bytes_ep": held_e}


def _pp_rank(mesh) -> dict:
    """granite at full width and depth as PAR_PP_STAGES stages of the pipe:
    the unpipelined mean over the microbatches first (loss and gradients
    kept on the host, memory freed), then one sealed pipelined step
    (``value_and_grad``), then the control that unseals the backward hop
    with the forward domain."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.parallel import pipeline

    cfg = configs.get_config(PAR_PP_ARCH)
    sid = mesh.get_local_rank("pod")
    M = PAR_PP_MICRO
    tok = torch.randint(0, cfg.vocab, (M, 1, PAR_PP_SEQ), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(SEED + 2))
    batch = {"tokens": tok, "labels": tok}
    key = torch.tensor(steps.CELL_KEY, dtype=torch.int32, device="cuda")

    def fresh():
        return TF.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                       "cuda")

    def mean(params):              # the microbatches' losses summed in order
        total = torch.zeros((), dtype=torch.float32, device="cuda")
        for j in range(M):
            total = total + TF.loss(params, cfg, {"tokens": tok[j],
                                                  "labels": tok[j]})
        return total / M

    torch.cuda.reset_peak_memory_stats()
    params = fresh()
    loss_ref, wall_ref = _fwd_bwd(params, mean)
    staged = pipeline.stack_params_by_stage(
        {k: _grad_tree(v) for k, v in params.items()}, PAR_PP_STAGES)
    ref = {p: (g[sid] if p.startswith("layers.") else g).cpu()
           for p, g in _tree_paths(staged).items()}
    del params, staged
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    torch.cuda.reset_peak_memory_stats()
    staged = pipeline.stack_params_by_stage(fresh(), PAR_PP_STAGES)
    fn = pipeline.make_pipelined_loss(cfg, mesh, PAR_PP_STAGES, M,
                                      seal_key=key)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fn.value_and_grad(staged, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    loss = loss.item()
    errs = _rel_errs(_tree_paths(grads), ref)
    # both ranks share the card: give back this step's cached blocks before
    # the control's step, or the two stages' peaks can meet at 80 GB
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    unseal = pipeline._unseal_hop
    pipeline._unseal_hop = (lambda ct, k, tick, sender, domain, dt: unseal(
        ct, k, tick, sender, pipeline.FWD_DOMAIN, dt))
    try:
        _, ctl = fn.value_and_grad(staged, batch)
    finally:
        pipeline._unseal_hop = unseal
    ctl = _rel_errs(_tree_paths(ctl), ref)
    del staged
    gc.collect()
    torch.cuda.empty_cache()
    return {"stage": sid, "loss_unpipelined": loss_ref, "loss": loss,
            "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "loss_bits_equal": (np.float32(loss).view(np.uint32) ==
                                np.float32(loss_ref).view(np.uint32)).item(),
            "grad_rel_max": max(errs.values()),
            "grad_worst_leaf": max(errs, key=errs.get),
            "grad_leaves_exact": sum(v == 0 for v in errs.values()),
            "grad_leaves": len(errs),
            "control_grad_rel_max": max(ctl.values()),
            "wall_s": wall, "wall_s_unpipelined": wall_ref,
            "launches": launches, "peak_bytes": peak}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad


def _restore_rank(mesh, path: str) -> dict:
    """granite's sealed parameters restored onto the (data 1, model 2)
    mesh by ``params_shardings``; each local ct and tags block against the
    matching slice of the same leaves sealed here."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.core import sealed as sealed_lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.train import fault

    cell = steps.make_cell(PAR_PP_ARCH, "train_4k")
    abstract = steps.abstract_params(cell)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, step = fault.elastic_restore(path, abstract, PAR_KEY_BYTES, mesh,
                                      cell.model.param_specs(cell.cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = sealed_lib.seal_tree(
        TF.init(torch.Generator(device="cuda").manual_seed(SEED), cell.cfg,
                "cuda"), cell.key, cell.sec.weights, 1 << 8)
    equal, held, sharded = True, 0, 0
    got, want = _tree_paths(got), _tree_paths(want)
    for p, st in got.items():
        equal &= st.nonce == want[p].nonce
        for f in ("ct", "tags"):
            d, w = getattr(st, f), getattr(want[p], f)
            size, off = compute_local_shape_and_global_offset(
                d.shape, d.device_mesh, d.placements)
            local = d.to_local()
            block = w[tuple(slice(o, o + n) for o, n in zip(off, size))]
            equal &= bool(torch.equal(local, block))
            held += local.numel() * local.element_size()
            sharded += local.numel() < d.numel()
    return {"step": step, "equal": equal, "wall_s": wall, "bytes_held": held,
            "blocks_sharded": sharded, "leaves": len(got)}


def _sharded_batch(cell, mesh, i: int) -> dict:
    """Step ``i``'s PAR_SH_MICRO microbatches of 1 x PAR_SH_SEQ tokens, as
    DTensors over the data axis (on the one process: plain tensors)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shd

    data = SyntheticLM(vocab=cell.cfg.vocab, seq_len=PAR_SH_SEQ, batch=1,
                       seed=SEED)
    batch = {k: torch.as_tensor(v, device=cell.key.device)
             for k, v in data.microbatches_at(i, PAR_SH_MICRO).items()}
    if mesh is None:
        return batch
    bsh = steps.batch_shardings(
        cell, mesh, {k: (tuple(v.shape), v.dtype) for k, v in batch.items()},
        stacked=True)
    return {k: shd.distribute(v, bsh[k]) for k, v in batch.items()}


def _collective_clock():
    """The dry run's count of the port's collectives (calls and bytes of
    each call's output, ``launch/dryrun.py::CollectiveCount``), each call
    also timed between two device syncs, while installed.  ``take()``
    gives {torch name: {calls, s, bytes}} since the last take, always
    with ``all_gather_into_tensor`` and ``all_reduce``."""
    from repro_torch.launch.dryrun import _HLO_NAMES, CollectiveCount

    class CollectiveClock(CollectiveCount):
        def _call(self, rec, fn, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["s"] = rec.get("s", 0.0) + time.perf_counter() - t0
            return res

        def take(self) -> dict:
            out = {n: {"calls": r.get("count", 0), "s": r.get("s", 0.0),
                       "bytes": int(r.get("bytes", 0))}
                   for n, op in _HLO_NAMES.items()
                   for r in [self.stats.get(op, {})]
                   if r or n in ("all_gather_into_tensor", "all_reduce")}
            self.stats = {}
            return out

    return CollectiveClock()


def _sharded_rank(mesh) -> dict:
    """granite at full width and depth, its sealed state sharded over the
    (data 1, model 2) mesh by ``train_state_shardings``: each rank seals
    its own blocks (``seal_state`` on DTensor leaves), takes PAR_SH_STEPS
    steps through ``make_train_step_fn`` in place under the mesh's
    context, then one with a flipped ciphertext bit in PAR_SH_TAMPER_RANK's
    block of a leaf sharded on its last axis."""
    from torch.distributed.tensor import Shard

    from repro_torch.core import sealed as sealed_lib
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import DTYPES
    from repro_torch.optim import TrainState
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import trainer

    cell = steps.make_cell(PAR_PP_ARCH, "train_4k")
    sh = steps.train_state_shardings(cell, mesh)
    dev = cell.key.device
    t0 = time.perf_counter()
    params = TF.init(torch.Generator(device=dev).manual_seed(SEED),
                     cell.cfg, dev)
    leaves = sealed_lib.tree_leaves(params)
    shs = [s.ct for s in sealed_lib.tree_leaves(sh.params)]
    for i, (x, s) in enumerate(zip(leaves, shs)):
        leaves[i] = shd.distribute(x, s)
    del params, x
    dt = DTYPES[cell.opt.state_dtype]
    mom = [[shd.distribute(torch.zeros(x.shape, dtype=dt, device=dev), s)
            for s, x in zip(shs, leaves)] for _ in range(2)]
    tree = sh.params                     # the parameters' tree structure
    plain = TrainState(
        step=shd.distribute(torch.zeros((), dtype=torch.int32), sh.step),
        params=sealed_lib.tree_unflatten(tree, leaves),
        mu=sealed_lib.tree_unflatten(tree, mom[0]),
        nu=sealed_lib.tree_unflatten(tree, mom[1]))
    state = trainer.seal_state(plain, cell.key, cell.sec)
    del plain, leaves, mom
    gc.collect()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = whole = 0
    for st in sealed_lib.tree_leaves((state.params, state.mu, state.nu)):
        for d in (st.ct, st.tags):
            local = d.to_local()
            held += local.numel() * local.element_size()
            whole += d.numel() * local.element_size()
            if any(isinstance(p, Shard) and mesh.size(i) > 1
                   for i, p in enumerate(d.placements)):
                check(local.numel() < d.numel(), "a sharded leaf held whole")
    torch.cuda.empty_cache()
    fn = steps.make_train_step_fn(cell, in_place=True)
    out = []
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with shd.use(shd.make_ctx(mesh)), _collective_clock() as clock:
        for i in range(PAR_SH_STEPS):
            b = _sharded_batch(cell, mesh, i)
            c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fn(state, b)
            torch.cuda.synchronize()
            out.append(dict(wall_s=time.perf_counter() - t1,
                            loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]),
                            seal_ok=bool(m["seal_ok"]),
                            ctr=ctr_ops.ctr_xor.launches - c0,
                            mac=mac_ops.mac_tags.launches - m0,
                            collectives=clock.take()))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    with shd.use(shd.make_ctx(mesh)):
        st = state.params
        for k in PAR_SH_TAMPER_LEAF:
            st = st[k]
        col_sharded = isinstance(st.ct.placements[-1], Shard)
        if mesh.get_rank() == PAR_SH_TAMPER_RANK:
            flat = st.ct.to_local().view(-1)
            flat[flat.numel() // 3] ^= 1 << 7
        state, m = fn(state, _sharded_batch(cell, mesh, PAR_SH_STEPS))
        tamper_ok = bool(m["seal_ok"])
        # every rank unseals the same leaves (an unseal may gather)
        nan = [bool(torch.isnan(sealed_lib.unseal(x, cell.key)[0]
                                .to_local()).all())
               for x in (state.params["final_norm"],
                         state.params["layers"]["mlp"]["w_gate"],
                         sealed_lib.tree_leaves(state.nu)[0])]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": out, "launches": launches, "peak_bytes": peak,
            "held_bytes": held, "whole_bytes": whole, "build_s": build_s,
            "tamper_leaf_col_sharded": col_sharded,
            "tamper_seal_ok": tamper_ok, "tamper_poisoned": all(nan)}


def _serve_cell():
    """granite's prefill_32k cell cut to PAR_SV_BATCH x PAR_SV_SLOTS."""
    import dataclasses

    from repro_torch.launch import steps
    cell = steps.make_cell(PAR_PP_ARCH, "prefill_32k")
    cell.shape = dataclasses.replace(cell.shape, seq_len=PAR_SV_SLOTS,
                                     global_batch=PAR_SV_BATCH)
    return cell


def _serve_inputs(cell):
    """The whole parameters and prompts of the sharded serving case, from
    SEED on the card."""
    from repro_torch.models import transformer as TF
    dev = cell.key.device
    params = TF.init(torch.Generator(device=dev).manual_seed(SEED),
                     cell.cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cell.cfg.vocab, (PAR_SV_BATCH, PAR_SV_PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    return params, {"tokens": tokens}


def serve_one_process() -> tuple[dict, list]:
    """The sharded serving case in this process on the whole sealed tree:
    (its times and peak, its logits of each call on the host), after the
    ranks have ended and freed the card."""
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.launch import steps

    cell = _serve_cell()
    params, batch = _serve_inputs(cell)
    sealed = sealed_lib.seal_tree(params, cell.key, cell.sec.weights, 1 << 8)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill, decode = steps.make_prefill_fn(cell), steps.make_decode_fn(cell)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(sealed, batch)
    torch.cuda.synchronize()
    out = {"prefill_s": time.perf_counter() - t0, "decode_s": []}
    got = [logits.float().cpu()]
    for _ in range(PAR_SV_STEPS):
        t0 = time.perf_counter()
        logits, state = decode(sealed, state,
                               logits.argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        out["decode_s"].append(time.perf_counter() - t0)
        got.append(logits.float().cpu())
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del sealed, state, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out, got


def _sharded_serve_rank(mesh, logits_path: str) -> dict:
    """granite at full width and depth, its sealed parameters sharded over
    the (data 1, model 2) mesh by ``params_shardings`` (each rank seals
    its own blocks): a prefill of PAR_SV_BATCH prompts into a
    PAR_SV_SLOTS-slot sealed cache and PAR_SV_STEPS greedy decode steps
    through ``make_prefill_fn`` / ``make_decode_fn`` under the mesh's
    context, with each call's gloo collectives and launches; then one
    decode step with a flipped ciphertext bit in PAR_SV_TAMPER_RANK's
    block of a parameter leaf.  Its logits of each call go to
    ``logits_path`` (the parent holds them against one process's)."""
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shd

    cell = _serve_cell()
    params, batch = _serve_inputs(cell)
    shs = [s.ct for s in sealed_lib.tree_leaves(
        steps.params_shardings(cell, mesh))]
    leaves = [shd.distribute(x, sh) for x, sh in
              zip(sealed_lib.tree_leaves(params), shs)]
    blocks = sealed_lib.tree_unflatten(params, leaves)
    del params, leaves
    bsh = steps.batch_shardings(
        cell, mesh, {k: (tuple(v.shape), v.dtype) for k, v in batch.items()},
        stacked=False)
    batch = {k: shd.distribute(v, bsh[k]) for k, v in batch.items()}
    tok_sh = steps.batch_shardings(cell, mesh,
                                   {"tokens": ((PAR_SV_BATCH,), torch.int32)},
                                   stacked=False)["tokens"]
    sealed = sealed_lib.seal_tree(blocks, cell.key, cell.sec.weights, 1 << 8)
    del blocks
    gc.collect()
    torch.cuda.empty_cache()
    prefill, decode = steps.make_prefill_fn(cell), steps.make_decode_fn(cell)
    calls, got = [], []

    def timed(fn, *args):
        c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        calls.append(dict(wall_s=time.perf_counter() - t0,
                          ctr=ctr_ops.ctr_xor.launches - c0,
                          mac=mac_ops.mac_tags.launches - m0,
                          collectives=clock.take()))
        return out

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with shd.use(shd.make_ctx(mesh)), _collective_clock() as clock:
        logits, state = timed(prefill, sealed, batch)
        got.append(logits.float().cpu())
        first = state["k_ct"].to_local().clone()
        for _ in range(PAR_SV_STEPS):
            tok = shd.distribute(logits.argmax(-1).to(torch.int32), tok_sh)
            logits, state = timed(decode, sealed, state, tok)
            got.append(logits.float().cpu())
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    changed = not torch.equal(first, state["k_ct"].to_local())
    del first
    held = whole = 0
    for d in [x for st in sealed_lib.tree_leaves(sealed)
              for x in (st.ct, st.tags)] + [v for v in state.values()
                                            if hasattr(v, "to_local")]:
        local = d.to_local()
        held += local.numel() * local.element_size()
        whole += d.numel() * local.element_size()
    with shd.use(shd.make_ctx(mesh)):
        st = sealed
        for k in PAR_SH_TAMPER_LEAF:
            st = st[k]
        if mesh.get_rank() == PAR_SV_TAMPER_RANK:
            flat = st.ct.to_local().view(-1)
            flat[flat.numel() // 3] ^= 1 << 7
        tok = shd.distribute(logits.argmax(-1).to(torch.int32), tok_sh)
        bad, _ = decode(sealed, state, tok)
        tamper_nan = bool(torch.isnan(bad).all())
    del sealed, state, bad, logits
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(got, logits_path)
    return {"prefill": calls[0], "decode": calls[1:], "launches": launches,
            "peak_bytes": peak, "held_bytes": held, "whole_bytes": whole,
            "block_changed": changed, "tamper_nan": tamper_nan}


def _dryrun_child(path: str) -> None:
    """The dry run's rows (``launch/dryrun.py``, meta device, a fake group
    of 2 ranks on make_smoke_mesh(2)) of the parallel phase's sharded
    cells: the serving prefill and decode step, and the sharded train
    step; written to ``path`` as JSON."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh

    cells = {
        "serve prefill": ("prefill_32k", {"seq_len": PAR_SV_SLOTS,
                                          "global_batch": PAR_SV_BATCH},
                          dict(prompt_len=PAR_SV_PROMPT)),
        "serve decode step": ("decode_32k", {"seq_len": PAR_SV_SLOTS,
                                             "global_batch": PAR_SV_BATCH},
                              {}),
        "sharded train step": ("train_4k", {"seq_len": PAR_SH_SEQ,
                                            "global_batch": PAR_SH_MICRO},
                               dict(microbatch=1))}
    t0 = time.perf_counter()
    with dryrun.fake_world(2):
        mesh = make_smoke_mesh(2, device_type="cpu")
        rows = {name: dryrun.run_cell(PAR_PP_ARCH, shape, mesh, "smoke_1x2",
                                      "trusted", cuts=cuts, **kw)
                for name, (shape, cuts, kw) in cells.items()}
    Path(path).write_text(json.dumps({"rows": rows,
                                      "s": time.perf_counter() - t0}))


def dryrun_against_card(rows: dict, ranks: list) -> dict:
    """{cell: {"collectives": {op: [dry-run calls, card calls, dry-run
    bytes, card bytes]}, "ctr": [...], "mac": [...], "peak_ratio"}} with
    every card call of the cell (each rank, each step) in the card's
    columns: the calls and bytes must be equal."""
    from repro_torch.launch.dryrun import _HLO_NAMES

    out = {}
    for cell, row in rows.items():
        card = []
        for r in ranks:
            if cell == "sharded train step":
                card += [(st, r["sharded"]["peak_bytes"])
                         for st in r["sharded"]["steps"]]
            elif cell == "serve prefill":
                card.append((r["sharded_serve"]["prefill"],
                             r["sharded_serve"]["peak_bytes"]))
            else:
                card += [(st, r["sharded_serve"]["peak_bytes"])
                         for st in r["sharded_serve"]["decode"]]
        coll = {}
        ops = set(row["collectives"]) | {
            _HLO_NAMES[k] for c, _ in card for k in c["collectives"]}
        for op in sorted(ops):
            dry = row["collectives"].get(op, {"count": 0, "bytes": 0})
            calls = sorted({c["collectives"].get(k, {}).get("calls", 0)
                            for c, _ in card for k in _HLO_NAMES
                            if _HLO_NAMES[k] == op})
            nbytes = sorted({c["collectives"].get(k, {}).get("bytes", 0)
                             for c, _ in card for k in _HLO_NAMES
                             if _HLO_NAMES[k] == op})
            coll[op] = [dry["count"], calls, dry["bytes"], nbytes]
        out[cell] = {
            "collectives": coll,
            "ctr": [row["ctr_launches"], sorted({c["ctr"] for c, _ in card})],
            "mac": [row["mac_launches"], sorted({c["mac"] for c, _ in card})],
            "peak_ratio": row["peak_bytes_per_device"] / max(
                p for _, p in card)}
    return out


def _counts_equal(check_row: dict) -> bool:
    return all(v[1] == [v[0]] and v[3] == [v[2]]
               for v in check_row["collectives"].values()) and all(
        check_row[k][1] == [check_row[k][0]] for k in ("ctr", "mac"))


def _par_rank(rank: int, port: int, out_dir: str, ckpt_path: str) -> None:
    """One of the phase's two processes: EP, then the pipeline, the
    elastic restore and the sharded sealed train step; its results go to
    ``out_dir/rank<r>.json``.  An exception ends the process with it (and
    fails the phase)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _init_gloo(rank, port, PAR_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        mesh = make_smoke_mesh(2)                            # data 1, model 2
        pipe = make_smoke_mesh(2, pods=2)                    # pod 2
        res = {"rank": rank, "mesh_s": time.perf_counter() - t0}
        res["ep"] = _ep_rank(mesh)
        dist.barrier()
        res["pipeline"] = _pp_rank(pipe)
        dist.barrier()
        res["restore"] = _restore_rank(mesh, ckpt_path)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        res["sharded"] = _sharded_rank(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        res["sharded_serve"] = _sharded_serve_rank(
            mesh, f"{out_dir}/serve_rank{rank}.pt")
        Path(f"{out_dir}/rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def hop_ctr_timing() -> dict:
    """One pipeline hop's seal through the CTR kernel (a [1, PAR_PP_SEQ,
    d_model] bf16 activation) in a CUDA graph, against its bound."""
    from repro_torch import configs
    from repro_torch.core import cipher
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.ctr_cipher import ref as ctr_ref
    from repro_torch.launch import steps
    from repro_torch.parallel import pipeline

    cfg = configs.get_config(PAR_PP_ARCH)
    x = torch.randn((1, PAR_PP_SEQ, cfg.d_model), dtype=torch.bfloat16,
                    device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    key = torch.tensor(steps.CELL_KEY, dtype=torch.int32, device="cuda")
    nonce = pipeline.hop_nonce(1, 0, pipeline.FWD_DOMAIN)
    # seal_bits' kernel launch, its tensor key derived outside the graph
    tkeys = cipher.derive_tensor_key(key.reshape(1, 2), nonce)
    x3 = x.view(torch.int16).reshape(1, -1, x.shape[-1])
    check(torch.equal(ctr_ops.ctr_xor(x3, tkeys).reshape(x.shape),
                      cipher.seal_bits(x, key, nonce)),
          "the hop's timed launch is not seal_bits")
    check(torch.equal(ctr_ops.ctr_xor(x3, tkeys),
                      ctr_ref.ctr_xor_ref(x3, tkeys)),
          "the hop's seal differs from the plain version")
    ms = graph_ms(lambda: ctr_ops.ctr_xor(x3, tkeys))
    plain_ms = device_ms(lambda: ctr_ref.ctr_xor_ref(x3, tkeys), reps=3)
    b = ctr_payload_bound(tuple(x.shape), x.dtype)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "bytes_per_tick": x.numel() * x.element_size(),
            "ctr_bytes": b["bytes"], "alu_ops": b["alu_ops"]}


def parallel_phase() -> dict:
    """(h) Two processes on the one card over gloo: which gloo operations
    take CUDA tensors, the hop's CTR time, then EP (moonshot at full
    width), the sealed pipeline (granite at full size), the elastic
    restore of granite's sealed parameters saved here with
    ``checkpoint.save``, and granite's sealed train step on the sharded
    state, against one step of the whole state taken here first; then
    granite's sealed prefill and decode on sharded parameters against one
    process's serving of the same, and the dry run's count of both sharded
    cells (``launch/dryrun.py`` in a process of its own meanwhile) against
    the card's."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    # the dry run's count of the sharded cells, on the host meanwhile
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = mp.get_context("spawn").Process(
        target=_dryrun_child, args=(f"{dry_dir}/rows.json",))
    dry.start()
    try:
        return _parallel_body(dry, dry_dir)
    finally:
        if dry.is_alive():
            dry.terminate()
            dry.join()
        shutil.rmtree(dry_dir, ignore_errors=True)


def _spawn_ranks(fn, args: tuple, nprocs: int, what: str) -> None:
    """``fn(rank, port, *args)`` in ``nprocs`` spawned processes; fails the
    run unless all end well within ``PAR_TIMEOUT_S``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(_free_port(), *args), nprocs=nprocs,
                             join=False, start_method="spawn")
    t_end = time.monotonic() + PAR_TIMEOUT_S
    try:
        while not ctx.join(timeout=2):
            check(time.monotonic() < t_end,
                  f"{what} did not end in {PAR_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()


def _parallel_body(dry, dry_dir: str) -> dict:
    """``parallel_phase`` with the dry run's process ``dry`` started."""
    import tempfile

    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.train import checkpoint, trainer

    t_phase = time.perf_counter()
    probe = gloo_cuda_probe()
    # moe_ep's collectives run on the card's tensors (the pipeline's hops
    # are staged through host memory)
    check(all(probe[op] == "ok" for op in ("all_reduce",
                                           "all_gather_into_tensor")),
          f"gloo refused a collective moe_ep runs on the card: {probe}")
    hop = hop_ctr_timing()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        # granite's sealed train state (its params are the restore's
        # checkpoint), then one step of it on the sharded case's first
        # batch in this process, before the ranks start
        cell = steps.make_cell(PAR_PP_ARCH, "train_4k")
        state = trainer.seal_state(cell.opt.init(TF.init(
            torch.Generator(device="cuda").manual_seed(SEED), cell.cfg,
            "cuda")), cell.key, cell.sec)
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(tmp, 0, state.params, PAR_KEY_BYTES)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(st.nbytes_ct + st.tags.numel() * 4
                         for st in _tree_paths(state.params).values())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps.make_train_step_fn(cell, in_place=True)(
            state, _sharded_batch(cell, None, 0))
        one = {"loss": float(m["loss"]), "seal_ok": bool(m["seal_ok"]),
               "grad_norm": float(m["grad_norm"]),
               "wall_s": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        check(one["seal_ok"] and np.isfinite(one["loss"]),
              f"the one-process step of the sharded case: {one}")
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        parent_bytes = torch.cuda.memory_reserved()
        _spawn_ranks(_par_rank, (tmp, path), 2, "the parallel phase's ranks")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(2)]
        serve_one, want = serve_one_process()
        for r in ranks:
            got = torch.load(f"{tmp}/serve_rank{r['rank']}.pt")
            r["sharded_serve"].update(
                tokens_equal=len(got) == len(want) and all(
                    torch.equal(a.argmax(-1), b.argmax(-1))
                    for a, b in zip(got, want)),
                logit_diff=max(float((a - b).abs().max())
                               for a, b in zip(got, want)))
    for r in ranks:
        ep, pp, rs = r["ep"], r["pipeline"], r["restore"]
        check(ep["loss_rel"] <= PAR_EP_LOSS_RTOL
              and ep["grad_rel_max"] <= PAR_EP_GRAD_RTOL,
              f"rank {r['rank']}: EP against the global dispatch {ep}")
        check(ep["control_grad_rel_max"] > PAR_EP_GRAD_RTOL,
              f"rank {r['rank']}: the EP control passed the limit {ep}")
        check(pp["loss_rel"] <= PAR_PP_LOSS_RTOL
              and pp["grad_rel_max"] <= PAR_PP_GRAD_RTOL,
              f"stage {pp['stage']}: pipeline against unpipelined {pp}")
        check(pp["launches"]["ctr_cipher"] > 0,
              f"stage {pp['stage']}: the pipelined step launched no CTR "
              f"kernel {pp['launches']}")
        check(rs["equal"] and rs["step"] == 0 and rs["blocks_sharded"] > 0,
              f"rank {r['rank']}: elastic restore {rs}")
    for r in ranks:
        sh = r["sharded"]
        first = sh["steps"][0]
        check(abs(first["loss"] - one["loss"]) <= PAR_SH_LOSS_ATOL,
              f"rank {r['rank']}: the sharded step's loss {first['loss']} "
              f"against one process's {one['loss']}")
        check(all(st["seal_ok"] and np.isfinite(st["loss"])
                  and st["ctr"] > 0 and st["mac"] > 0 for st in sh["steps"]),
              f"rank {r['rank']}: sharded steps {sh['steps']}")
        check(sh["tamper_leaf_col_sharded"] and not sh["tamper_seal_ok"]
              and sh["tamper_poisoned"],
              f"rank {r['rank']}: a flipped bit on rank "
              f"{PAR_SH_TAMPER_RANK} did not poison the state: {sh}")
        check(0 < sh["held_bytes"] < sh["whole_bytes"],
              f"rank {r['rank']}: holds {sh['held_bytes']} of "
              f"{sh['whole_bytes']} sealed bytes")
    check(len({r["sharded"]["steps"][-1]["loss"] for r in ranks}) == 1,
          "the sharded step's ranks returned different losses")
    for r in ranks:
        sv = r["sharded_serve"]
        check(sv["tokens_equal"], f"rank {r['rank']}: the sharded serving's "
              f"tokens differ from one process's (largest logit difference "
              f"{sv['logit_diff']})")
        check(sv["tamper_nan"], f"rank {r['rank']}: a flipped bit on rank "
              f"{PAR_SV_TAMPER_RANK} did not poison the logits")
        check(0 < sv["held_bytes"] < sv["whole_bytes"],
              f"rank {r['rank']}: holds {sv['held_bytes']} of "
              f"{sv['whole_bytes']} sealed bytes")
        check(all(c["ctr"] > 0 for c in [sv["prefill"]] + sv["decode"])
              and sv["prefill"]["mac"] > 0,
              f"rank {r['rank']}: a sharded serving call launched no CTR "
              f"or MAC kernel")
        # rank 0 holds the prompts' slots, rank 1 the decode writes
        check(sv["block_changed"] == (r["rank"] == 1),
              f"rank {r['rank']}: its cache block changed by the decode "
              f"steps: {sv['block_changed']}")
    dry.join(timeout=PAR_TIMEOUT_S)
    if dry.is_alive():
        dry.terminate()
    check(dry.exitcode == 0, f"the dry run of the sharded cells ended with "
          f"{dry.exitcode}")
    dry_out = json.loads(Path(f"{dry_dir}/rows.json").read_text())
    dry_check = dryrun_against_card(dry_out["rows"], ranks)
    for cell, c in dry_check.items():
        check(dry_out["rows"][cell]["status"] == "ok" and _counts_equal(c),
              f"the dry run's {cell} counts differ from the card's: {c}")
    check(ranks[0]["pipeline"]["loss"] == ranks[1]["pipeline"]["loss"],
          "the pipeline's stages returned different losses")
    check(max(r["pipeline"]["control_grad_rel_max"] for r in ranks)
          > PAR_PP_GRAD_RTOL,
          "the pipeline's wrong-domain control passed the gradient limit")
    return {"probe": probe, "hop": hop, "ranks": ranks, "save_s": save_s,
            "ckpt_bytes": ckpt_bytes, "one_process": one,
            "serve_one_process": serve_one, "dryrun_check": dry_check,
            "parent_reserved_bytes": parent_bytes,
            "dryrun_s": dry_out["s"],
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the examples phase: the four examples, the serve launcher and the three
# observability tools of the checkout, on the card
# ---------------------------------------------------------------------------

EX_TRAIN_STEPS, EX_MULTIPOD_STEPS = 30, 8     # the examples' own defaults


def _script(folder: str, name: str):
    """``<folder>/<name>.py`` of the checkout as a module.  The folder joins
    sys.path, so processes spawned from here import it too."""
    import importlib
    path = str(ROOT / folder)
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _multipod_rank(pod: int, port: int, out_dir: str, kwargs: dict) -> None:
    """One pod of the multipod example on the card (its ``train_pod``), its
    gloo calls counted and timed by ``_collective_clock`` and its CTR and
    MAC launches read over the whole run; the result goes to
    ``out_dir/pod<p>.json``."""
    ex = _script("examples", "multipod_training_torch")
    zero_launches()
    with _collective_clock() as clock:
        res = ex.train_pod(pod, port, **kwargs)
    res["gloo"] = clock.take()
    res["launches"] = read_launches()
    Path(f"{out_dir}/pod{pod}.json").write_text(json.dumps(res))


def _payload_tree(cfg) -> dict:
    """Gradients of ``cfg``'s parameter shapes on the card, N(0, 1), by
    leaf order (the cross-pod hook's payload)."""
    from repro_torch.models import registry
    params = registry.get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return {f"{i:03d}": torch.randn(x.shape, generator=gen, device="cuda")
            for i, x in enumerate(_leaves(params))}


def examples_phase() -> dict:
    """The four examples through their ``run`` on the card at their own
    sizes, then the serve launcher with ``--trace`` and ``--audit`` and the
    three tools on its files.  Every check raises; each part's launches
    are zeroed just before it and read just after."""
    import io
    import tempfile

    from repro_torch import configs
    from repro_torch.core import SecureChannel
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import steps as steps_lib

    out = {}
    t_phase = time.perf_counter()
    # secure serving: granite-3-2b SMOKE, sealed against plaintext
    ex = _script("examples", "secure_serving_torch")
    vocab = configs.get_config("granite-3-2b", smoke=True).vocab
    zero_launches()
    t0 = time.perf_counter()
    r = ex.run("cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(r["sealed_equals_plain"],
          "secure_serving: sealed tokens differ from the plaintext engine's")
    check(r["tokens"].shape == (ex.BATCH, ex.N_NEW)
          and ((r["tokens"] >= 0) & (r["tokens"] < vocab)).all(),
          f"secure_serving: bad tokens {r['tokens']}")
    check(launches["ctr_cipher"] > 0 and launches["tree_mac"] > 0,
          f"secure_serving launched {launches}")
    out["serving"] = {"wall_s": wall, "sealed_ms": r["ms"],
                      "launches": launches,
                      "launches_verified": r["launches_verified"],
                      "first_tokens": r["tokens"][:, 0].tolist()}

    # quickstart: handshake, seal, serve, tamper, two tenants, preemption
    ex = _script("examples", "quickstart_torch")
    zero_launches()
    t0 = time.perf_counter()
    r = ex.run("cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()
    o = r["oversubscribed"]
    last = (f"{o['statuses'].count('done')}/{o['requests']} done, "
            f"swaps out/in {o['swap_outs']}/{o['swap_ins']}")
    check(last == "6/6 done, swaps out/in 2/2", f"quickstart ended {last}")
    check(not r["tamper_ok"], "quickstart: the tampered ciphertext verified")
    check(r["tokens"].shape == (2, 8) and len(r["alice"]) == 6
          and len(r["bob"]) == 6 and r["gateway"]["tokens"] == 12,
          f"quickstart: short streams {r['tokens']} {r['alice']} {r['bob']}")
    check(launches["ctr_cipher"] > 0 and launches["tree_mac"] > 0,
          f"quickstart launched {launches}")
    out["quickstart"] = {
        "wall_s": wall, "last": last, "launches": launches,
        "ciphertext_words": r["ciphertext_words"],
        "sealed_bytes_per_token": r["gateway"]["sealed_bytes_per_token"],
        "page_closes": r["gateway"]["page_closes"],
        "occupancy_pct": o["occupancy_pct"]}

    # secure training at --full100m: 30 steps through the injected failure
    ex = _script("examples", "secure_training_torch")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    r = ex.run("cuda", steps=EX_TRAIN_STEPS, **ex.FULL100M)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    ev, losses = r["events"], r["losses"]
    check(losses[-1] < losses[0], f"secure_training: loss {losses[0]} -> "
                                  f"{losses[-1]}")
    check(ev["failures"] == 1 and ev["restarts"] == 1,
          f"secure_training events {ev}")
    check(r["final_step"] == EX_TRAIN_STEPS and all(r["seal_ok"]),
          f"secure_training ended at {r['final_step']}, seal_ok "
          f"{r['seal_ok']}")
    check(all(x.is_cuda for x in _leaves(r["final_state"].params)),
          "secure_training: the final state left the card")
    check(all(launches[k] >= len(losses) for k in ("ctr_cipher", "tree_mac")),
          f"secure_training: {launches} launches over {len(losses)} steps")
    out["training"] = {
        "wall_s": wall, "n_params": r["n_params"], "losses": losses,
        "executed_steps": len(losses), "events": ev,
        "step_s": r["step_s"], "peak_bytes": peak, "launches": launches}
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # multipod: the example's host handshake, then its two pods as two gloo
    # processes on the card, each counted by _multipod_rank
    ex = _script("examples", "multipod_training_torch")
    channel = SecureChannel.establish(device="cuda")
    kwargs = dict(key_words=channel.key_words.tolist(),
                  key_bytes=channel.key_bytes, steps=EX_MULTIPOD_STEPS,
                  device="cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pods_") as tmp:
        _spawn_ranks(_multipod_rank, (tmp, kwargs), ex.N_PODS,
                     "the multipod example's pods")
        res = [json.loads(Path(f"{tmp}/pod{p}.json").read_text())
               for p in range(ex.N_PODS)]
    wall = time.perf_counter() - t0
    check(len({tuple(p["digests"]) for p in res}) == 1,
          "multipod: the pods' sealed states differ")
    check(all(p["losses"][-1] < p["losses"][0] for p in res),
          "multipod: the loss did not fall on every pod: "
          + json.dumps([p["losses"] for p in res]))
    pods = []
    for p in res:
        n = len(p["losses"])
        gather = p["gloo"]["all_gather_into_tensor"]
        check(all(p["seal_ok"]) and n == EX_MULTIPOD_STEPS,
              f"multipod pod {p['pod']}: seal_ok {p['seal_ok']}")
        check(p["launches"]["ctr_cipher"] >= n and gather["calls"] >= n,
              f"multipod pod {p['pod']}: {p['launches']} launches, "
              f"{gather['calls']} all-gathers over {n} steps")
        pods.append({
            "pod": p["pod"], "losses": p["losses"], "step_s": p["step_s"],
            "launches": p["launches"],
            "gloo_s_per_step": sum(op["s"] for op in p["gloo"].values()) / n,
            "gather_calls_per_step": gather["calls"] / n,
            "payload_bytes_per_step": gather["bytes"] / n / ex.N_PODS})
    cfg = steps_lib.make_cell("granite-3-2b", "train_4k", smoke=True).cfg
    key = torch.tensor(steps_lib.CELL_KEY, dtype=torch.int32, device="cuda")
    seal = payload_seal(_payload_tree(cfg), key, quantize=True)
    out["multipod"] = {"wall_s": wall, "mesh": res[0]["mesh"], "pods": pods,
                       "seal": seal}

    # the serve launcher's trace, audit and metrics through the three tools
    va = _script("tools", "verify_audit_torch")
    t2p = _script("tools", "trace2perfetto_torch")
    od = _script("tools", "obs_dash_torch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        audit, trace = f"{d}/audit.jsonl", f"{d}/trace.jsonl"
        zero_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gw = serve_launch.main(["--arch", "granite-3-2b", "--trace",
                                    f"{d}/trace.json", "--audit", audit])
        wall = time.perf_counter() - t0
        launches = read_launches()
        check("chain OK" in buf.getvalue(),
              f"serve launcher: {buf.getvalue()[-400:]}")
        n_events = gw.export_trace(trace, fmt="jsonl")
        Path(f"{d}/metrics.prom").write_text(gw.metrics_text())
        rc_ok = va.main([audit, audit + ".key", "--quiet"])
        lines = Path(audit).read_text().splitlines()
        rec = json.loads(lines[1])
        rec["kind"] = rec["kind"] + "-edited"
        lines[1] = json.dumps(rec, sort_keys=True)
        Path(f"{d}/edited.jsonl").write_text("\n".join(lines) + "\n")
        rc_edit = va.main([f"{d}/edited.jsonl", audit + ".key", "--quiet"])
        check(rc_ok == 0 and rc_edit == 1,
              f"verify_audit_torch exited {rc_ok} on the export, {rc_edit} "
              "on the edited copy (want 0, 1)")
        with contextlib.redirect_stdout(io.StringIO()):
            rc_t = t2p.main([trace, f"{d}/trace.chrome.json"])
        events = json.loads(Path(f"{d}/trace.chrome.json").read_text())
        check(rc_t == 0 and len(events["traceEvents"]) == n_events > 0,
              f"trace2perfetto_torch: rc {rc_t}, "
              f"{len(events['traceEvents'])} of {n_events} events")
        dash = io.StringIO()
        with contextlib.redirect_stdout(dash):
            rc_d = od.main([f"{d}/metrics.prom", audit])
        check(rc_d == 0 and "secure-gateway posture" in dash.getvalue(),
              f"obs_dash_torch: rc {rc_d}")
        check(launches["ctr_cipher"] > 0 and launches["tree_mac"] > 0,
              f"serve launcher launched {launches}")
        out["tools"] = {
            "wall_s": wall, "launches": launches, "audit_records":
            len(lines) - 1, "trace_events": n_events,
            "verify_rc": [rc_ok, rc_edit], "dash_lines":
            len(dash.getvalue().splitlines())}
        del gw
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def print_examples(ex: dict, card: str) -> None:
    s, q, t, m, o = (ex[k] for k in ("serving", "quickstart", "training",
                                     "multipod", "tools"))
    print(f"examples secure_serving: granite-3-2b SMOKE, 4 x 16-token "
          f"prompts, 12 new tokens, sealed == plaintext; sealed generation "
          f"{s['sealed_ms']:.1f} ms, example {s['wall_s']:.2f} s; launches "
          f"{json.dumps(s['launches'])}; first tokens {s['first_tokens']}; "
          f"{card}", flush=True)
    print(f"examples quickstart: {q['ciphertext_words']} ciphertext words; "
          f"tamper detected; sealed bytes per decode token "
          f"{q['sealed_bytes_per_token']:.0f} (page closes "
          f"{q['page_closes']}); oversubscribed -> {q['last']}, occupancy "
          f"{q['occupancy_pct']:.0f}%; {q['wall_s']:.2f} s; launches "
          f"{json.dumps(q['launches'])}; {card}", flush=True)
    st = sorted(t["step_s"])
    print(f"examples secure_training --full100m: {t['n_params']} params, "
          f"{t['executed_steps']} executed steps for {EX_TRAIN_STEPS} "
          f"(failure at {EX_TRAIN_STEPS // 2}); loss {t['losses'][0]:.4f} -> "
          f"{t['losses'][-1]:.4f}; events {json.dumps(t['events'])}; step "
          f"{st[len(st) // 2] * 1e3:.1f} ms median ({st[0] * 1e3:.1f}-"
          f"{st[-1] * 1e3:.1f}); peak memory {t['peak_bytes'] / 2**30:.3f} "
          f"GiB; (ctr, mac) launches {t['launches']['ctr_cipher']}, "
          f"{t['launches']['tree_mac']} over the run (seal, restore and "
          f"unseal included), "
          f"{t['launches']['ctr_cipher'] / t['executed_steps']:.1f}, "
          f"{t['launches']['tree_mac'] / t['executed_steps']:.1f} an executed "
          f"step; {t['wall_s']:.1f} s; {card}", flush=True)
    for p in m["pods"]:
        st = sorted(p["step_s"])
        n = len(p["losses"])
        print(f"examples multipod pod {p['pod']}: granite-3-2b SMOKE on mesh "
              f"{json.dumps(m['mesh'])}, losses "
              f"{' '.join(f'{x:.4f}' for x in p['losses'])}; step "
              f"{st[len(st) // 2] * 1e3:.1f} ms median; gloo "
              f"{p['gloo_s_per_step'] * 1e3:.1f} ms a step, "
              f"{p['gather_calls_per_step']:.1f} all-gathers a step, sealed "
              f"payload {p['payload_bytes_per_step']:.0f} bytes a step; "
              f"(ctr, mac) launches {p['launches']['ctr_cipher']}, "
              f"{p['launches']['tree_mac']} over the run (the state's seal "
              f"included), {p['launches']['ctr_cipher'] / n:.1f}, "
              f"{p['launches']['tree_mac'] / n:.1f} a step; {card}",
              flush=True)
    sl = m["seal"]
    print(f"examples multipod: pod states equal after every step; one pod's "
          f"int8 payload seal through the CTR kernel {sl['ms']:.4f} ms in "
          f"CUDA graphs over {sl['bytes']} bytes read and written, bound "
          f"{sl['bound_ms']:.5f} ms ({sl['bound_by']}); two pods "
          f"{m['wall_s']:.1f} s; {card}", flush=True)
    print(f"examples tools: serve launcher (granite-3-2b SMOKE, --trace, "
          f"--audit) {o['wall_s']:.2f} s, launches "
          f"{json.dumps(o['launches'])}; verify_audit_torch exit "
          f"{o['verify_rc'][0]} on {o['audit_records']} records, "
          f"{o['verify_rc'][1]} on a copy with one record edited; "
          f"trace2perfetto_torch {o['trace_events']} events; obs_dash_torch "
          f"{o['dash_lines']} lines; {card}", flush=True)
    print(f"examples: phase {ex['phase_s']:.1f} s; {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs
    from repro_torch.core.channel import SecureChannel
    from repro_torch.kernels import build
    from repro_torch.kernels.sealed_attention import ref as sa_ref
    from repro_torch.models import transformer
    from repro_torch.obs import Profiler
    from repro_torch.serve.engine import TOKEN_POISON

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for r in (build.library(n) for n in build.SOURCES):
        check(r is not None, "library did not load")
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in build.build_log.items()}
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)};"
          f" ptxas {json.dumps(regs)}", flush=True)
    # the redesigned kernels' registers, shared memory and spills, and the
    # SASS opcode mix of every kernel (IADD3/LOP3/SHF/LEA/PRMT on the ALU
    # pipe, IMAD on the FMA pipe): a Threefry block has 20 rotates (SHF)
    for name in ("sealed_matmul", "sealed_attention", "tree_mac"):
        print(f"ptxas {name}: "
              f"{json.dumps(ptxas_report(build.build_log.get(name, '')))}",
              flush=True)
    smem = build.library("sealed_matmul").sealed_matmul_smem_bytes
    print("sealed_matmul dynamic shared memory by cluster (M x N): "
          + json.dumps({f"{cm}x{cn}": smem(cm, cn)
                        for cm, cn in ((4, 2), (4, 1), (2, 2), (2, 1))}),
          flush=True)
    sass = {}
    for name in build.SOURCES:
        for fn, mix in build.sass_mix(name).items():
            sass[f"{name}: {kernel_name(fn)}"] = mix
    print(f"sass mix {json.dumps(sass)}", flush=True)
    print(f"MAC word on the ALU pipe: "
          f"{mac_word_alu_ops(build.sass('sealed_matmul'))} instructions in "
          f"verify_chunks_kernel (the bound counts {MAC_ALU_OPS_PER_WORD})",
          flush=True)

    # 2. weights: full-width granite-3-2b, sealed by the provider ---------
    cfg = configs.get_config("granite-3-2b")
    t0 = time.perf_counter()
    provider = SecureChannel.establish(device="cuda")
    tenants = {"tenant_a": SecureChannel.establish(device="cuda"),
               "tenant_b": SecureChannel.establish(device="cuda")}
    params = transformer.init(torch.Generator(device="cuda").manual_seed(SEED),
                              cfg, "cuda")
    n_params = sum(x.numel() for x in _leaves(params))
    sealed = provider.upload_tree(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ct_bytes = sum(leaf.nbytes_ct for leaf in _leaves(sealed))
    print(f"weights: {n_params} params, {ct_bytes} ciphertext bytes, sealed in"
          f" {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions -----------------------------
    results = kernel_checks(sealed, provider.jkey)
    for name, cases in results.items():
        for c in cases:
            print(f"check {name:10s} {c['shape']}: mismatches {c['mismatches']}"
                  f", kernel {c['ms']:.4f} ms in a CUDA graph ("
                  f"{c['event_ms']:.4f} ms events), plain "
                  f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})", flush=True)
            check(c["mismatches"] == 0,
                  f"{name} disagrees with its plain version on {c['shape']}")
    torch.cuda.empty_cache()
    attn_cases, attn_tamper, attn_controls = attention_checks()
    for c in attn_cases:
        print(f"check sealed_attention [8 x 8 kv heads x 4 x 64] {c['shape']}: "
              f"max abs err {c['max_abs_err']:.3g}, kernel {c['ms']:.4f} ms "
              f"device ({c['kernels_per_call']:.2f} kernels a call seen; "
              f"{c['graph_ms']:.4f} ms in a CUDA graph; "
              f"{c['event_ms']:.4f} ms events), plain "
              f"{c['plain_ms']:.3f} ms, sdpa over plaintext "
              f"{c['library_ms']:.4f} ms device ({c['library_event_ms']:.4f}"
              f" ms events), bound {c['bound_ms']:.4f} ms ({c['bound_by']})",
              flush=True)
    print(f"check sealed_attention tamper at t_valid 700, bad rows "
          f"{json.dumps(attn_tamper)}; limit rejects the faulty controls, "
          f"max abs err {json.dumps(attn_controls)}", flush=True)
    torch.cuda.empty_cache()
    mm = matmul_checks(sealed, provider.jkey)
    for c in mm["cases"]:
        print(f"check sealed_matmul {c['shape']}: max abs err "
              f"{c['max_abs_err']:.3g} (atol {c['atol']:.3g}, excess "
              f"{c['excess']:.3g}), bad sum {c['bad_sum']}", flush=True)
    for c in mm["mlp"]:
        print(f"check sealed_matmul {c['shape']}: max abs err "
              f"{c['max_abs_err']:.3g} (atol {c['atol']:.3g}), kernel "
              f"{c['ms']:.4f} ms device ({c['kernels_per_call']:.2f} kernels"
              f" a call seen; {c['event_ms']:.4f} ms events), "
              f"plain {c['plain_ms']:.3f} ms, torch.matmul over plaintext "
              f"{c['library_ms']:.4f} ms device ({c['library_event_ms']:.4f}"
              f" ms events), bound {c['bound_ms']:.4f} ms ({c['bound_by']});"
              f" cluster {c['cluster'][0]}x{c['cluster'][1]} of 128x256 "
              f"blocks, keystream work {c['keystream_ops'] / 1e9:.1f} G ops",
              flush=True)
    print(f"check sealed_matmul tamper bad grids {json.dumps(mm['tamper'])}"
          f"; limit rejects the faulty controls, excess "
          f"{json.dumps(mm['controls'])}; entry point over the MLP products "
          f"launched the kernel {mm['launches']} times", flush=True)
    torch.cuda.empty_cache()
    t_scan = time.perf_counter()
    scans = scan_checks()
    print_scan_checks(scans, card)
    new_work = {"scan checks": time.perf_counter() - t_scan}
    flash = flash_checks()
    print_flash_checks(flash, card)

    # 4. serve ------------------------------------------------------------
    profiler = Profiler(chunk_words=CHUNK_WORDS)
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, steps, wall, launches = serve(cfg, sealed, provider, tenants,
                                             profiler)
    pool = eng.pool
    n_tokens = sum(len(r.tokens_out) for r in reqs)
    for r in reqs:
        check(r.status == "done", f"request {r.rid} ended {r.status}")
        check(len(r.tokens_out) == MAX_NEW, f"request {r.rid} short")
        check(all(0 <= t < cfg.vocab and t != TOKEN_POISON
                  for t in r.tokens_out), f"request {r.rid} bad tokens")
    for s in steps:
        check(s["ctr"] > 0 and s["mac"] > 0,
              f"a {s['kind']} step launched no kernel: {s}")
        check(not s["poisoned"], f"poisoned lanes {s}")
    st = pool.stats
    check(st["page_closes"] > 0, "no page closed")
    want = (st["decode_tokens"] * 2 * pool.slot_bytes
            + st["page_closes"] * 2 * pool.page_bytes)
    check(st["sealed_bytes_decode"] == want,
          f"sealed_bytes_decode {st['sealed_bytes_decode']} != {want}")
    phases = {p: {"calls": c["calls"], "ms": c["wall_us"] / 1e3}
              for p, c in profiler.ledger.phase_totals().items()}
    per_decode = sorted({(s["ctr"], s["mac"]) for s in steps
                         if s["kind"] == "decode" and s["closes"] == 0})
    # the fused attention's forward calls a prefill call and a decode step
    flash_per = {kind: sorted({s["flash"] for s in steps
                               if s["kind"] == kind})
                 for kind in ("prefill", "decode")}
    check(flash_per["decode"] == [0] and max(flash_per["prefill"]) > 0,
          f"fused attention calls a prefill and a decode step: {flash_per}")
    print(f"serve: {len(reqs)} requests, {n_tokens} tokens in {wall:.3f} s = "
          f"{n_tokens / wall:.2f} tok/s; {len(steps)} engine steps; phases "
          f"{json.dumps(phases)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"serve: launches {json.dumps(launches)}; per decode step without a"
          f" close (ctr, mac) {per_decode}; sealed bytes "
          f"{json.dumps({k: st[k] for k in st})}", flush=True)
    print("serve: tokens " + json.dumps({r.rid: r.tokens_out[:8]
                                         for r in reqs}), flush=True)

    # 5. the smoke config on the card against the CPU ---------------------
    (cpu_tok, cpu_stats), (gpu_tok, gpu_stats) = smoke_reference()
    check(cpu_tok == gpu_tok, f"smoke tokens differ: {cpu_tok} vs {gpu_tok}")
    check(cpu_stats == gpu_stats, "smoke sealed-byte counters differ")
    print("reference: smoke config on cuda == cpu, "
          f"{sum(len(t) for t in gpu_tok.values())} tokens", flush=True)

    # 6. tamper -----------------------------------------------------------
    poisoned, profile = tamper(eng, tenants, provider, cfg.vocab)
    print(f"tamper: page bit of tenant_a poisoned {poisoned['page']}; "
          f"weight bit poisoned {poisoned['weight']}", flush=True)
    print(f"profile: one decode step (4 lanes) {json.dumps(profile)}",
          flush=True)
    del eng, pool
    torch.cuda.empty_cache()

    # 7. the fixed-slot engine, unfused then fused -------------------------
    runs, layer, logit_err = fixed_phase(cfg, sealed, provider)
    plain_run, fused_run = runs[False], runs[True]
    n_fixed = FIXED_B * FIXED_NEW
    agree = float((plain_run["tokens"] == fused_run["tokens"]).mean())
    for name, r in (("unfused", plain_run), ("fused", fused_run)):
        print(f"fixed {name}: {n_fixed} tokens in {r['wall']:.3f} s = "
              f"{n_fixed / r['wall']:.2f} tok/s; launches "
              f"{json.dumps(r['launches'])}; sealed_attention per decode "
              f"step {sorted(set(r['sa_per_step']))}", flush=True)
    for name, r in (("unfused", plain_run), ("fused", fused_run)):
        print(f"profile: one {name} fixed decode step (8 lanes) "
              f"{json.dumps(r['profile'])}", flush=True)
    print(f"fixed: token agreement fused vs unfused {agree:.4f}, first tokens "
          f"equal, first decode logits max abs diff {logit_err:.4g}; first "
          f"tokens {plain_run['tokens'][:, 0].tolist()}", flush=True)
    print(f"fixed: one layer at t_valid {layer['t_valid']}: kernel "
          f"{layer['ms']:.4f} ms device in a CUDA graph (profiler "
          f"{layer['profiler_ms']:.4f} ms with "
          f"{layer['kernels_per_call']:.2f} kernels a call seen; "
          f"{layer['event_ms']:.4f} ms events; of the graph's time its own "
          f"zeroing of the counters {layer['counters_ms']:.5f} ms),"
          f" fused with key derivation {layer['fused_event_ms']:.4f} ms "
          f"events, CTR unseal + plain attention {layer['unfused_ms']:.4f} "
          f"ms device (profiler, {layer['unfused_kernels_per_call']:.1f} "
          f"kernels a call seen; {layer['unfused_event_ms']:.4f} ms events),"
          f" plain "
          f"version {layer['plain_ms']:.3f} ms events, sdpa over plaintext "
          f"{layer['library_ms']:.4f} ms device in a CUDA graph (profiler "
          f"{layer['library_profiler_ms']:.4f} ms; "
          f"{layer['library_event_ms']:.4f} ms events), bound "
          f"{layer['bound_ms']:.4f} ms ({layer['bound_by']}); max abs err "
          f"{layer['max_abs_err']:.3g} (plain version), "
          f"{layer['max_abs_err_vs_unfused']:.3g} (unfused path); weight "
          f"tamper poisoned every lane",
          flush=True)

    # 8. the gateway: sessions, prefix cache, preemption, audit -----------
    gw = gateway_phase(cfg)
    print(f"gateway: {gw['tokens']} tokens in {gw['wall']:.3f} s = "
          f"{gw['tok_per_s']:.2f} tok/s; swap out/in {gw['swap_outs']}/"
          f"{gw['swap_ins']}; prefix hits/misses {gw['prefix_hits']}/"
          f"{gw['prefix_misses']}; audit chain OK over "
          f"{gw['audit_records']} records; sealed bytes/decode-token "
          f"{gw['sealed_bytes_per_token']:.0f}; launches "
          f"{json.dumps(gw['launches'])}; page tamper of tenant_a "
          f"{json.dumps(gw['tamper'])}", flush=True)
    print(f"profile: one gateway step (4 lanes) {json.dumps(gw['profile'])}",
          flush=True)
    del sealed
    torch.cuda.empty_cache()

    # 9. sealed training at full size, then the smoke config vs the CPU ---
    tr = train_phase(cfg)
    for i, st in enumerate(tr["steps"]):
        print(f"train: step {i} loss {st['loss']:.4f}, grad norm "
              f"{st['grad_norm']:.4f}, seal_ok {st['seal_ok']}, "
              f"{st['wall_s']:.3f} s = "
              f"{tr['tokens_per_step'] / st['wall_s']:.0f} tok/s, launches "
              f"ctr {st['ctr']} mac {st['mac']} flash_forward "
              f"{st['flash_forward']} flash_backward {st['flash_backward']}",
              flush=True)
        check(st["flash_forward"] > 0 and st["flash_backward"] > 0,
              f"train step {i} did not run the fused attention: {st}")
    print(f"train: {TRAIN_STEPS} steps of {tr['tokens_per_step']} tokens, "
          f"sealed state {tr['sealed_bytes']} bytes, peak memory "
          f"{tr['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{json.dumps(tr['launches'])}; reduced from train_4k "
          f"{json.dumps(tr['reduced'])}; a flipped mu bit poisoned the "
          f"state", flush=True)
    print(f"profile: one train step {json.dumps(tr['profile'])}", flush=True)
    p = tr["profile"]
    print(f"train: profiled step {p['wall_ms']:.1f} ms wall = "
          f"{tr['tokens_per_step'] / p['wall_ms'] * 1e3:.0f} tok/s, "
          f"{p['device_busy_ms']:.1f} ms busy, idle "
          f"{p['device_idle_share']:.3f}", flush=True)
    ref = smoke_train_reference()
    (cpu_l, cpu_ev), (gpu_l, gpu_ev) = ref["cpu"], ref["cuda"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(cpu_l, gpu_l))
    check(len(cpu_l) == len(gpu_l) and rel <= 1e-4,
          f"smoke training losses differ: {cpu_l} vs {gpu_l}")
    check(cpu_ev == gpu_ev and gpu_ev["failures"] == 1,
          f"smoke training events differ: {cpu_ev} vs {gpu_ev}")
    print(f"reference: smoke training on cuda == cpu, losses within "
          f"{rel:.2g} relative over {len(gpu_l)} steps, events "
          f"{json.dumps(gpu_ev)}", flush=True)

    # 10. the other families at full size through the fixed-slot engine --
    gc.collect()
    torch.cuda.empty_cache()
    t_fam = time.perf_counter()
    fams = {}
    for arch in FAMILY_ARCHS:
        fams[arch] = family_phase(arch, card)
        print_family(fams[arch], card)
    print(f"families: {len(fams)} configurations in "
          f"{time.perf_counter() - t_fam:.1f} s", flush=True)
    ref = moe_smoke_reference()
    check(np.array_equal(ref["cpu"], ref["cuda"]),
          f"llama4 smoke tokens differ: {ref['cpu'].tolist()} vs "
          f"{ref['cuda'].tolist()}")
    check(ref["cuda_launches"]["ctr_cipher"] > 0
          and ref["cuda_launches"]["tree_mac"] > 0,
          f"llama4 smoke launched {ref['cuda_launches']}")
    print(f"reference: llama4-maverick-400b-a17b smoke config sealed on cuda"
          f" == cpu, {ref['cuda'].size} tokens, launches "
          f"{json.dumps(ref['cuda_launches'])}", flush=True)

    # 11. sealed training of every family: MoE and enc-dec at full width,
    # each SMOKE config on the card against the CPU, the cross-pod hook ---
    gc.collect()
    torch.cuda.empty_cache()
    t_tf = time.perf_counter()
    tfs = {}
    for arch in TRAIN_FAMILY_ARCHS:
        t_arch = time.perf_counter()
        tfs[arch] = train_family_phase(arch)
        print_train_family(tfs[arch], card)
        if arch in LONG_PREFILL_ARCHS:
            new_work[f"train {arch}"] = time.perf_counter() - t_arch
    smoke_tf = smoke_train_families()
    for arch, r in smoke_tf.items():
        print(f"train-families smoke {arch}: one sealed step on cuda == cpu"
              f" (loss {r['loss_cuda']:.6f} vs {r['loss_cpu']:.6f}, rel "
              f"{r['loss_rel']:.2g}; parameters at most "
              f"{r['worst_over_lr']:.3g} lr apart, {r['off_share']:.2g} of "
              f"the entries past 1e-3 of the move + 0.05 lr; moments "
              f"{r['moments']}, accumulators {r['acc']}); launches "
              f"{json.dumps(r['launches'])}", flush=True)
    from repro_torch.launch import steps as steps_lib
    xpod = crosspod_check(tfs[CROSSPOD_ARCH].pop("grads"),
                          torch.tensor(steps_lib.CELL_KEY, dtype=torch.int32,
                                       device="cuda"))
    for mode in ("f32", "int8"):
        x = xpod[mode]
        print(f"crosspod: {CROSSPOD_ARCH}'s gradients of one step "
              f"({xpod['leaves']} leaves, {xpod['payload_bytes']} f32 "
              f"bytes), one-pod NCCL group, quantize "
              f"{'on' if mode == 'int8' else 'off'}: "
              + ("returned bit for bit" if mode == "f32" else
                 f"within {x['worst_int8_steps']:.4f} half int8 steps")
              + f"; hook {x['wall_ms']:.1f} ms wall, launches "
              f"{json.dumps(x['launches'])}; one pod's seal through the CTR"
              f" kernel {x['ctr_ms']:.4f} ms in CUDA graphs over "
              f"{x['ctr_bytes']} bytes read and written, bound "
              f"{x['ctr_bound_ms']:.4f} ms ({x['bound_by']}); {card}",
              flush=True)
    print(f"train-families: {len(tfs)} configurations, {len(smoke_tf)} SMOKE"
          f" configs and the cross-pod hook in "
          f"{time.perf_counter() - t_tf:.1f} s", flush=True)

    # 11b. the recurrent families' long sealed prefill ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    longs = {}
    for arch in LONG_PREFILL_ARCHS:
        t_arch = time.perf_counter()
        longs[arch] = long_prefill_phase(arch)
        print_long_prefill(longs[arch], card)
        new_work[f"prefill {arch}"] = time.perf_counter() - t_arch
    print(f"recurrences: the scans' new work took "
          f"{sum(new_work.values()):.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in new_work.items())})",
          flush=True)

    # 12. two processes on the one card over gloo: expert parallelism, the
    # sealed pipeline, the elastic restore ---
    gc.collect()
    torch.cuda.empty_cache()
    par = parallel_phase()
    print_parallel(par, card)
    print_sharded(par, card)
    print_sharded_serve(par, card)

    # 13. the four examples, the serve launcher and the three tools -------
    gc.collect()
    torch.cuda.empty_cache()
    exs = examples_phase()
    print_examples(exs, card)

    # 14. report ----------------------------------------------------------
    sources = {"ctr_cipher": ("src/repro_torch/csrc/ctr_cipher.cu",
                              "src/repro/kernels/ctr_cipher/kernel.py:43"),
               "tree_mac": ("src/repro_torch/csrc/tree_mac.cu",
                            "src/repro/kernels/tree_mac/kernel.py:53")}
    per_step = {}
    if per_decode:
        per_step = {"ctr_cipher": per_decode[0][0],
                    "tree_mac": per_decode[0][1]}
    kernels = []
    for name, cases in results.items():
        # one decode step's work: the whole weight tree plus the k and v
        # page-batch gathers (the slot and tag_root work is kept apart)
        step = [c for c in cases
                if c["shape"].startswith(("weight", "page gather"))]
        ms = sum(c["ms"] * c["per_step"] for c in step)
        event_ms = sum(c["event_ms"] * c["per_step"] for c in step)
        plain = sum(c["plain_ms"] * c["per_step"] for c in step)
        nbytes = sum(c["bytes"] * c["per_step"] for c in step)
        ops = sum(c["ops"] * c["per_step"] for c in step)
        alu = sum(c["alu_ops"] * c["per_step"] for c in step)
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, alu / INT32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "launches_per_decode_step": per_step.get(name),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "mismatches": sum(c["mismatches"] for c in cases),
            "ms": ms, "event_ms": event_ms, "plain_ms": plain,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_ms_74": max(tb, ops / INT32_OPS_PER_S * 1e3),
            "library_ms": None,
            "workload": "weight tree + k and v page-batch gathers of one "
                        "decode step; ms in a CUDA graph",
            "shapes": [{k: c[k] for k in ("shape", "ms", "event_ms",
                                          "plain_ms", "bound_ms", "bound_by")}
                       for c in cases]})
    # one fused decode step: the kernel once per layer over the fixed
    # phase's cache
    n_l = cfg.n_layers
    kernels.append({
        "name": "sealed_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/sealed_attention.cu",
        "replaces": "src/repro/kernels/sealed_attention/kernel.py:122",
        "launches": fused_run["launches"]["sealed_attention"],
        "launches_per_decode_step": (fused_run["sa_per_step"][0]
                                     if len(set(fused_run["sa_per_step"]))
                                     == 1 else fused_run["sa_per_step"]),
        "max_abs_err": max([c["max_abs_err"] for c in attn_cases]
                           + [layer["max_abs_err"]]),
        "tolerance": {"rtol": sa_ref.OUT_RTOL, "atol": sa_ref.OUT_ATOL},
        "control_max_abs_err": attn_controls,
        "ms": layer["ms"] * n_l, "event_ms": layer["event_ms"] * n_l,
        "counters_ms": layer["counters_ms"] * n_l,
        "profiler_ms": layer["profiler_ms"] * n_l,
        "profiler_kernels_per_call": layer["kernels_per_call"],
        "plain_ms": layer["plain_ms"] * n_l,
        "bound_ms": layer["bound_ms"] * n_l, "bound_by": layer["bound_by"],
        "bound_ms_74": layer["bound_ms_74"] * n_l,
        "library_ms": layer["library_ms"] * n_l,
        "library_event_ms": layer["library_event_ms"] * n_l,
        "library_call": "F.scaled_dot_product_attention over the decrypted "
                        "cache (attention only)",
        "workload": f"one fused decode step: {n_l} layers at B {FIXED_B}, "
                    f"T {FIXED_MAX_LEN}, t_valid {layer['t_valid']}, "
                    "verify off",
        "unfused_ms": layer["unfused_ms"] * n_l,
        "unfused_event_ms": layer["unfused_event_ms"] * n_l,
        "shapes": [{k: c[k] for k in ("shape", "ms", "event_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
                   for c in attn_cases]})
    # the sealed matmul's path: its entry point over granite's two MLP
    # products of one 8192-token microbatch
    n_mlp = len(mm["mlp"])
    times = {k: sum(c[k] for c in mm["mlp"])
             for k in ("ms", "event_ms", "plain_ms", "library_ms",
                       "library_event_ms", "bound_ms", "bound_ms_74")}
    kernels.append({
        "name": "sealed_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/sealed_matmul.cu",
        "replaces": "src/repro/kernels/sealed_matmul/kernel.py:118",
        "launches": mm["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in mm["cases"] + mm["mlp"]),
        "tolerance": {"rtol": "2^-6", "atol": "K 2^-24 max|A| max|B|"},
        "control_excess": mm["controls"], **times,
        "bound_by": ("operations" if all(c["bound_by"] == "operations"
                                         for c in mm["mlp"]) else "bytes"),
        "library_call": "torch.matmul over the decrypted bf16 operands",
        "workload": f"ops.matmul over {n_mlp} MLP products of one "
                    f"{MLP_PRODUCTS[0][1]}-token microbatch (w_gate, "
                    f"w_down of layer 0), verify on",
        "keystream_ops": sum(c["keystream_ops"] for c in mm["mlp"]),
        "shapes": [{k: c[k] for k in ("shape", "ms", "event_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "keystream_ops", "cluster")}
                   for c in mm["mlp"]]})
    # the fused causal attention, forward and backward: granite's training
    # layer and its serving prefill chunk at FLASH_SHAPES; launches of the
    # paths below, a train step's and a serving call's
    for name in ("flash_forward", "flash_backward"):
        rows = [c for c in flash if c["name"] == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/models/layers.py:76-97 (a jnp chain; no "
                        "Pallas kernel)",
            "launches_per_train_step": sorted({st[name]
                                               for st in tr["steps"]}),
            **({"launches_per_prefill_call": flash_per["prefill"],
                "launches_per_decode_step": flash_per["decode"]}
               if name == "flash_forward" else {}),
            "max_abs_err": max(c["max_abs_err"] for c in rows),
            "tolerance": ("float32 output 2^-16 max|v|, bf16 output 2^-8 "
                          "relative" if name == "flash_forward" else
                          "2^-8 relative + 2^-14 of each gradient's largest "
                          "entry"),
            "repeat_bitwise": all(c["repeat_bitwise"] for c in rows),
            **{k: rows[0][k] for k in ("ms", "kernel_ms", "plain_ms",
                                       "chain_ms", "library_ms", "flops",
                                       "bound_ms")},
            "bound_by": "operations",
            "library_call": "F.scaled_dot_product_attention (a yardstick; "
                            "the port never calls it)",
            **({"peak_bytes": rows[0]["peak_bytes"]}
               if "peak_bytes" in rows[0] else {}),
            "workload": f"one layer's call at {rows[0]['shape']} "
                        f"{rows[0]['dims']} (B, S, T, K, G, hd); ms in CUDA "
                        "events; the bound counts the causal FLOPs at the "
                        "bf16 rate",
            "shapes": [{k: c[k] for k in ("shape", "dims", "ms", "kernel_ms",
                                          "plain_ms", "chain_ms",
                                          "library_ms", "bound_ms")}
                       for c in rows]})
    by_path = {"paged": launches, "fixed_unfused": plain_run["launches"],
               "fixed_fused": fused_run["launches"],
               "gateway": gw["launches"],
               "sealed_matmul": {**{k: 0 for k in launches},
                                 "sealed_matmul": mm["launches"]},
               "train": tr["launches"]}
    for arch, f in tfs.items():
        by_path[f"train {arch}"] = f["launches"]
    by_path["train SMOKE configs"] = {
        k: sum(r["launches"][k] for r in smoke_tf.values())
        for k in launches}
    by_path["parallel pipeline step"] = {
        k: sum(r["pipeline"]["launches"][k] for r in par["ranks"])
        for k in launches}
    by_path["parallel sharded train steps"] = {
        k: sum(r["sharded"]["launches"][k] for r in par["ranks"])
        for k in launches}
    by_path["parallel sharded serving"] = {
        k: sum(r["sharded_serve"]["launches"][k] for r in par["ranks"])
        for k in launches}
    by_path["examples"] = {
        k: (sum(exs[p]["launches"][k] for p in ("serving", "quickstart",
                                                "training", "tools"))
            + sum(p["launches"][k] for p in exs["multipod"]["pods"]))
        for k in launches}
    for arch, f in fams.items():
        by_path[f"{arch} sealed"] = f["sealed"]["launches"]
        if "fused" in f:
            by_path[f"{arch} fused"] = f["fused"]["launches"]
    for k in kernels:
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in by_path.items()}
        if k["name"].startswith("flash_"):
            k["launches"] = sum(k["launches_by_path"].values())
    # per configuration of the families phase: one sealed decode step's
    # weight unseal (CUDA graphs, every leaf once) and its launches
    for k in kernels[:2]:
        pre = "ctr" if k["name"] == "ctr_cipher" else "mac"
        k["families"] = {arch: {
            "step_ms": f["step"][f"{pre}_ms"],
            "bound_ms": f["step"][f"{pre}_bound_ms"],
            "launches_per_decode_step": f["sealed"]["steps"][0][k["name"]],
            **({"general_path_ms": f["step"]["general_ms"],
                "general_path_bound_ms": f["step"]["general_bound_ms"]}
               if pre == "mac" else {})} for arch, f in fams.items()}
    kernels[0]["pipeline_hop"] = {
        "launches_per_step": [r["pipeline"]["launches"]["ctr_cipher"]
                              for r in par["ranks"]],
        **{k: par["hop"][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "bytes_per_tick")},
        "workload": f"one hop's seal of a [1, {PAR_PP_SEQ}, d_model] bf16 "
                    f"activation of {PAR_PP_ARCH}; ms in a CUDA graph"}
    for k in kernels[:2]:
        pre = "ctr" if k["name"] == "ctr_cipher" else "mac"
        k["sharded_train"] = {
            "launches_per_step_per_rank": [[st[pre] for st in
                                            r["sharded"]["steps"]]
                                           for r in par["ranks"]],
            "workload": f"{PAR_PP_ARCH}'s sealed train step on mesh (data 1,"
                        f" model 2), {PAR_SH_MICRO} x 1 x {PAR_SH_SEQ} "
                        "tokens, each rank its blocks",
            "offset_cases": [{c: x[c] for c in ("shape", "col0",
                                                "mismatches", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by") if c in x}
                             for x in results[k["name"]]
                             if x["shape"].startswith("sharded")]}
    for k in kernels[:2]:
        pre = "ctr" if k["name"] == "ctr_cipher" else "mac"
        k["sharded_serve"] = {
            "launches_prefill_per_rank": [r["sharded_serve"]["prefill"][pre]
                                          for r in par["ranks"]],
            "launches_per_decode_step_per_rank": [
                sorted({st[pre] for st in r["sharded_serve"]["decode"]})
                for r in par["ranks"]],
            "dryrun_launches": {cell: c[pre] for cell, c in
                                par["dryrun_check"].items()},
            "workload": f"{PAR_PP_ARCH}'s sealed prefill of {PAR_SV_BATCH} "
                        f"x {PAR_SV_PROMPT} tokens into {PAR_SV_SLOTS} slots "
                        f"and {PAR_SV_STEPS} decode steps on mesh (data 1, "
                        "model 2), each rank its blocks"}
    kernels[0]["crosspod"] = {
        mode: {k: xpod[mode][k] for k in ("ctr_ms", "ctr_bound_ms",
                                          "bound_by", "ctr_bytes")}
        for mode in ("f32", "int8")}
    kernels[0]["crosspod"]["two_pods_int8"] = {
        "ctr_ms": exs["multipod"]["seal"]["ms"],
        "ctr_bound_ms": exs["multipod"]["seal"]["bound_ms"],
        "bound_by": exs["multipod"]["seal"]["bound_by"],
        "ctr_bytes": exs["multipod"]["seal"]["bytes"],
        "workload": "one pod's int8 payload of the multipod example "
                    "(granite-3-2b SMOKE gradients)"}
    for k in kernels[:2]:
        k["train_families"] = {arch: {
            "launches_per_step": f["steps"][0][
                "ctr" if k["name"] == "ctr_cipher" else "mac"]}
            for arch, f in tfs.items()}
    # RWKV-6's and Mamba-2's scans: one layer's call at scan_shapes();
    # launches of the recurrent families' train steps and long prefills
    scan_paths = {**{f"train {a}": tfs[a]["launches"]
                     for a in LONG_PREFILL_ARCHS},
                  **{f"prefill {a} {LONG_PREFILL_LEN}": longs[a][
                      LONG_PREFILL_LEN]["launches"]
                     for a in LONG_PREFILL_ARCHS}}
    for c in scans:
        name = c["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name.split('_')[0]}_scan.cu",
            "replaces": f"{c['replaces']} (jax.lax.scan; no Pallas kernel)",
            "launches": sum(p.get(name, 0) for p in scan_paths.values()),
            "launches_by_path": {p: v.get(name, 0)
                                 for p, v in scan_paths.items()},
            "launches_per_train_step": {
                a: tfs[a]["steps"][0]["scans"].get(name, 0)
                for a in LONG_PREFILL_ARCHS},
            "max_abs_err": c["max_abs_err"], "tolerance": c["tolerance"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None,
            "checkpoints": {
                k: c[k] for k in ("ms_with_checkpoints", "checkpoint_bytes",
                                  "bound_with_checkpoints_ms") if k in c},
            **{k: c[k] for k in ("plan", "kernel_ms", "repeat_bitwise",
                                 "zero_decay_err") if k in c},
            "workload": f"one layer's call at {list(c['shape'])}; ms in a "
                        "CUDA graph; the bound counts the function's own "
                        "operands, the checkpoints' bytes apart"})
    lay = fams["qwen3-4b"]["fused"]["layer"]
    kernels[2]["families"] = {"qwen3-4b fused": {
        "layer_ms": lay["ms"], "bound_ms": lay["bound_ms"],
        "plain_ms": lay["plain_ms"], "t_valid": lay["t_valid"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in fams["qwen3-4b"]["fused"]["checks"])}}
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    from repro_torch.core.sealed import tree_leaves
    return tree_leaves(tree)


if __name__ == "__main__":
    sys.exit(main())
