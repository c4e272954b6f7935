"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels
    python3 chip_smoke.py --train
    python3 chip_smoke.py --int8
    python3 chip_smoke.py --export
    python3 chip_smoke.py --lm

Builds the port's CUDA kernels from ``handwritten_chinese_ocr_samples_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card, then serves seeded text-line images through ``ServingDaemon`` at the
full ``hctr`` width on the greedy and the beam route, and on the LM-fused
beam route with the full-width char LM (full search, then the skip search,
``-ss``), runs the skip search at the JAX bench's config #5 (B 32, T 1200
peaky posteriors), serves the 150 test lines of ``demo/hard`` with the
trained weights converted into ``handwritten_chinese_ocr_samples_torch/
assets/demo_hard`` against the JAX package's committed texts, on the device
routes and on the host beam's (the n-gram skip search, the skip search
without an LM, and LM proposals alone, with the native decoder built from
the port's C++ source), runs the port's eval CLI (``cli/test.py -bm``) on
demo/hard's three commands of ``demo/hard/RESULTS.md``, then trains
(``train_parity``, ``train_full``, ``train_cli``), and checks what comes
out.

int8 serving (kernel I1, ``csrc/int8_conv.cu``: the quantize and the s8 x s8
-> s32 implicit-GEMM conv entry points; the conv on a TMA-fed ``wgmma``
kernel where Cin is a multiple of 64, else on an ``mma.sync`` kernel):

  * ``int8_kernels``: I1 timed at the five heaviest site shapes of the
    full-width forward at b4 w1600, the conv on both kernels beside its
    bound, its plain version, the library route (im2col +
    ``torch._int_mm``) and the site's bf16 cuDNN convolution, the
    quantize beside its plain version and its bytes bound; then held bit
    for bit against its plain versions (the conv on both kernels where the
    shape takes ``wgmma``) at every distinct site shape of ``hctr`` and
    ``hctr-tiny``, the LM's GEMM shapes and edge cases;
  * ``serve_int8``: the seeded full-width ``hctr`` through
    ``ServingDaemon`` with ``int8=True`` (greedy, the ``serve`` lines),
    beside the bf16 engine: lines/s, forward ms at each bucket, peak
    memory, 33 sites and a forward's launches (33 quantize; 32 convs on
    ``wgmma``, 1 on ``mma.sync``);
  * ``demo_hard_int8``: demo/hard's 150 lines in f32 on the greedy and the
    ``-ss --lm-int8`` routes, on JAX's calibration (``int8.json``: the
    JAX int8 engine's texts, near-ties reported) and on the port's own
    (CER and lines against the float route);
  * ``eval_demo_hard`` adds ``--int8`` to the greedy command and ``--int8
    --lm-int8`` to the LM one, each CER within ``INT8_EVAL_CER_TOL`` of
    the JAX eval's at the same command.

Every phase prints one JSON line; any failed check raises, so the exit
code is non-zero. The last line is ``{"ok": true, "device": {...}}``.

The training phases launch none of K1-K4 (training reaches no TPU kernel):

  * ``train_parity``: one SGD and one Adam step of ``hctr-tiny`` in f32
    (dropout 0) from the same seeded weights on the card, held against the
    same step on the CPU with f64 activations (loss, gradients, new
    parameters, new running statistics) within the ``TRAIN_*_TOL``
    tolerances or the CPU's own f32 distance from it; ``dropout_recompute``'s
    backward mask equal to its forward's, and its keep fractions.
  * ``train_full``: 30 steps of the full-width ``hctr`` (bf16 compute, f32
    parameters, dropout on) at ``demo/full/RESULTS.md``'s recipe on
    ``demo/full``'s training lines, through the port's ``Trainer``: ms a
    step, lines/s, the share of the bf16 peak, peak memory, the idle share
    under torch.profiler, the same with ``remat``; every loss finite, no
    step skipped, the loss falling.
  * ``train_cli``: ``cli/train.py`` in a subprocess, a warm start from the
    converted demo/hard weights and one epoch of demo/hard's training
    lines, at seeds 0, 1 and 2: the JAX checkpoint names, the mean test
    accuracy within ``TRAIN_CLI_ACC_TOL`` of the JAX CLI's mean at the
    same seeds, and the eval CLI's CER on seed 0's checkpoint equal to
    ``1 - acc``.

Export and the LM tooling (no new kernel; the int8 programs call I1 through
its custom ops):

  * ``export``: the seeded full-width ``hctr`` (bf16) through
    ``cli/export.py`` at ``-b 4 -w 512,1024,1600``, then again with
    ``--int8-calib demo/hard/data/test``, each loaded program's ``(chars,
    lengths)`` equal to the eager model + greedy on the serve phase's 16
    lines (33 I1 launches a forward for int8); demo/hard's ``hctr-tiny``
    in f32 and int8, its 150 lines served from the loaded programs equal
    to the eager routes (and the float texts to the JAX engine's); the LM
    bundle's scores against ``LMScorer``'s within ``LM_EXPORT_TOL`` a
    token; export wall times, file sizes and program ms beside eager ms;
  * ``lm_train``: demo/hard's LM trained by the port on the card
    (``tools/make_hard_demo.train_lm``'s recipe, the corpus from this
    file's copy of the demo's chain sampler), saved, and served on
    demo/hard ``-ss`` (CER at most ``HARD_LM_CER_TOL``); held-out NLL
    beside the JAX-trained LM's; 20 timed train steps of ``char-512x6``;
  * ``ngram_train``: ``cli/lm_train_ngram.py`` on the same corpus, byte
    for byte the committed ``demo/hard/lm/ngram.arpa`` and ``ngram.hblm``,
    and ``cli/lm_binarize.py --check``.

``--int8`` runs only the build and the int8 phases; ``--export`` only the
build and ``export``; ``--lm`` only the build, ``lm_train`` and
``ngram_train``. ``--kernels`` runs
only the build and the kernel phases: K1 at the shapes of ``K1_SHAPES``,
K2-K4 on a seeded frame of the served LM route's shapes and
``int8_kernels``, timing the kernels before checking them. ``--train``
runs only the training phases. None of these prints the ``ok`` line.

It needs a CUDA card and the repository around it: without either it fails
before printing any result. TF32 is switched off for convolutions and matrix
products, so f32 work on the card is full f32.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from handwritten_chinese_ocr_samples_torch.cli import export as export_cli
from handwritten_chinese_ocr_samples_torch.cli import (
    lm_binarize, lm_train_ngram)
from handwritten_chinese_ocr_samples_torch.core.codec import (
    CTCCodec, load_chars_list)
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as blm
from handwritten_chinese_ocr_samples_torch.decode.beam_device import (
    beam_search_fused, beam_search_from_topk)
from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
    TorchLMBackend)
from handwritten_chinese_ocr_samples_torch.lm.infer import LMScorer
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm, save_lm
from handwritten_chinese_ocr_samples_torch.lm.model import (
    CharTransformerLM, get_lm_config)
from handwritten_chinese_ocr_samples_torch.lm.train import (
    AdamW, lm_schedule, make_lm_train_step, train_char_lm)
from handwritten_chinese_ocr_samples_torch.models.registry import get_model_info
from handwritten_chinese_ocr_samples_torch.ops import _build
from handwritten_chinese_ocr_samples_torch.ops import cache_gather as k4
from handwritten_chinese_ocr_samples_torch.ops import int8_conv as ic
from handwritten_chinese_ocr_samples_torch.ops import logits_lse as k3
from handwritten_chinese_ocr_samples_torch.ops import peek_attention as k2
from handwritten_chinese_ocr_samples_torch.ops import topk_logsoftmax as k1
from handwritten_chinese_ocr_samples_torch.ops.decode import greedy_decode_device
from handwritten_chinese_ocr_samples_torch.serve import export, quant
from handwritten_chinese_ocr_samples_torch.serve.daemon import ServingDaemon
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from handwritten_chinese_ocr_samples_torch.utils.posteriors import (
    synth_peaky_logits)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    quant_flax_to_torch, seeded_lm_state_dict, seeded_state_dict)

CHARS_LIST = "demo/full/data/chars_list.txt"
WIDTHS = (512, 1024, 1600)
BATCH = 4
N_REQUESTS = 16
SEARCH_DEPTH = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache
SPIN_CYCLES = 10_000_000       # first spin of device_ms, about 5 ms
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
K1_OPS_PER_LOGIT = 8           # max, sub, exp, add, sub, compare, add, top-K compare
K1_TOL = 1e-5                  # |vals|, |blank| vs plain: f32 sums in another order
K1_CLASSES = 7375
# K1 timed at (B, T): the smoke's shape, the beam route's widest and a
# narrower bucket, and the LM route's batch
K1_SHAPES = ((8, 1024), (4, 1600), (4, 512), (4, 128))
FWD_TOL = 1e-4                 # f32 forward, card vs CPU: conv sums in another order
# K2 on bf16 inputs: f32 sums in another order move the scores by ~1e-6, and
# a weight that lands on the other side of a bf16 rounding step moves o by
# one bf16 step of that weight; l and m see only the f32 order
K2_REL_TOL = 1e-3              # max |o - plain| / max |plain|, same for l
K2_M_TOL = 1e-3                # max |m - plain|
K3_TOL = 1e-3                  # |LSE - plain|: f32 dot products in another order
K4_TOL = 0.0                   # a copy: exact
NEAR_TIE = 1e-5                # LM route: kernel vs plain totals at a divergence
# The bf16 LM: K2 sums P·V in another order than its plain version and the
# rounding of o to bf16 then differs by a step now and then (K2_REL_TOL),
# which moves a beam's total by up to 0.036 over a config #5 decode (a
# chip run measured it: the largest difference of one hypothesis's totals
# in the two runs); hypotheses this close are a near-tie at bf16
BF16_NEAR_TIE = 0.05
# The LM route's shapes (trap: the LM's context is 160, and a seeded hctr
# emits a character on almost every frame, so lines stay within 158 frames)
LM_WIDTH = 128
LM_REQUESTS = 8
LM_SEED = 1
LM_LAYERS, LM_HEADS, LM_DHEAD, LM_CTX = 6, 8, 64, 160
LM_VOCAB = 7377                # 4 specials + the 7373 characters
LM_BEAMS = BATCH * 10          # G = 4 lines of BM = 10 beams
LM_ROWS = 21                   # 1 stay row + K = 10 visual + M = 10 LM rows
LM_SC = 4                      # peek positions run per row (S1 - 1)
# The skip search at the JAX bench's config #5 (bench.py:174-240): peaky
# posteriors of a trained recognizer's statistics (utils/posteriors.py),
# the seeded char-512x6 LM, lm_panelty 0.8, len_bonus 4.8, group 8
PEAKY_B, PEAKY_T, PEAKY_SEED = 32, 1200, 0
SS_LP, SS_LB, SS_GROUP = 0.8, 4.8, 8
RUN_MAX = 8                    # char-fast frames a segment (the default)
# The trained demo/hard artifact: hctr-tiny and the 128d/3L char LM,
# converted by tools/convert_to_torch.py, and the JAX engine's texts
DEMO_HARD = "demo/hard/data"
DEMO_ASSETS = "handwritten_chinese_ocr_samples_torch/assets/demo_hard"
LM_HARD_LAYERS = 3
NGRAM_HARD = "demo/hard/lm/ngram.hblm"
# The host-beam routes of demo/hard (-lp 0.8 -lb 0.0, recognizer and LM in
# f32): ServingEngine keywords, "lm" naming the backend; texts.json holds
# the JAX engine's texts for each under the same key
HOST_ROUTES = {
    "ngram_ss": dict(lm="ngram", use_lm_score=True, skip_search=True),
    "ss_nolm": dict(skip_search=True),
    "utp": dict(lm="tfm", use_lm_pred=True),
}
# LM proposals alone ask the LM once a searched frame: 150 lines took 149 s
# on an H100 (1.01 lines/s), so the route serves the first 32
UTP_LINES = 32
# demo/hard/RESULTS.md's three eval commands, after "-m hctr-tiny -f
# <weights> -i demo/hard/data -bm -b 8", with the CER it reports
EVAL_COMMANDS = {
    "greedy": (["-dm", "greedy-search"], 0.0887),
    "lm_ss": (["-dm", "beam-search", "-utp", "-uts", "-tp",
               f"{DEMO_ASSETS}/lm", "-ss", "-lp", "0.8", "-lb", "0.0"], 0.0),
    "ngram_ss": (["-dm", "beam-search", "-ss", "-kp", NGRAM_HARD, "-lp",
                  "0.8", "-lb", "0.0"], 0.0015),
}
# The eval CER on the card against RESULTS.md's: 7 of the 1375 test
# characters; bf16 forwards on two backends part at near-ties
EVAL_CER_TOL = 0.005
# K2 is held on the eval LM command's first call with a cache this deep
# (demo/hard's lines hold 7-12 characters): a one-token cache is a copy
EVAL_K2_DEPTH = 8
# int8 (kernel I1): the conv sites of a full-width hctr and of hctr-tiny
# forward; I1 timed at the full-width forward's heaviest site shapes; a
# site's calibrated absmax at this share of its input's largest value, so
# that some values clip
INT8_OPS_PER_S = 1979e12       # H100 SXM data sheet, dense int8 tensor cores
HCTR_SITES, TINY_SITES = 33, 17
# of which on I1's wgmma route (Cin a multiple of 64): all but conv0_1 of
# hctr; hctr-tiny's five 64-channel sites
HCTR_WGMMA, TINY_WGMMA = 32, 5
INT8_TIMED = 5
INT8_AMAX_SHARE = 0.8
# seeded full-width hctr: int8 vs bf16 logits within this share of the
# bf16 logits' largest (tests/test_quant_int8.py:93-95's rule)
INT8_LOGIT_TOL = 0.15
# tests/test_torch_int8.py holds the port's int8 logits within this share of
# JAX int8's distance from float; a line that differs from the JAX int8
# text is a near-tie where its top-2 gap is below twice that
INT8_JAX_SHARE = 0.1
# demo/hard on the port's own calibration against the float route: the CER
# and the lines that differ (the JAX test's 3 in 16, over 150 lines)
INT8_CER_TOL = 0.02
INT8_LINES_DIFFER = 28
# the eval CLI's int8 commands against the JAX eval's CER at the same
# command (int8.json)
INT8_EVAL_CER_TOL = 0.01
EVAL_INT8_COMMANDS = {
    "greedy_int8": (EVAL_COMMANDS["greedy"][0] + ["--int8"], "greedy"),
    "lm_ss_int8": (EVAL_COMMANDS["lm_ss"][0] + ["--int8", "--lm-int8"],
                   "lm_ss"),
}
# train_parity: hctr-tiny on demo/hard's classes in f32 (TF32 off), dropout
# 0, one SGD and one Adam step from the same seeded weights on the card
# and on the CPU (f32, and f64 activations as the reference), on a seeded
# batch
PARITY_B, PARITY_W, PARITY_L, PARITY_SEED = 8, 256, 12, 0
PARITY_LR = {"SGD": 0.01, "Adam": 1e-3}
# f32 convolutions and the CTC sum in other orders on the two devices
TRAIN_LOSS_TOL = 1e-5          # relative
# of each tensor's largest |g|; of the model's for a conv bias that feeds
# a train-mode BatchNorm, whose gradient is 0 in exact arithmetic
TRAIN_GRAD_TOL = 1e-4
# times lr: a step moves an element by about lr at most
TRAIN_PARAM_TOL = 1e-3
# Adam's first step moves each element by about lr * sign(u), u the clipped
# gradient plus the weight decay: an element whose |u| is under this share
# of its tensor's largest (or within the f32 noise, see adam_flips) may
# flip, so it is counted and bounded by 2 lr instead
ADAM_FLIP_SHARE = 1e-4
TRAIN_STAT_TOL = 1e-5          # new running statistics, absolute
# f32 on the CPU lies up to 6e-3 of a tensor's largest gradient from f64
# here (ReLU inputs within f32 rounding of 0 flip): the card's f32 may lie
# as far from f64 as this many times the CPU's, where that exceeds a
# tolerance above
F32_NOISE_MARGIN = 4
DROPOUT_RATES = (0.1, 0.3, 0.9)
DROPOUT_N = 1 << 24            # draws a rate for the keep fraction (4 sigma)
# train_full: demo/full/RESULTS.md's recipe (Adam, lr 5e-4, batch 16, seed
# 42, --max-width 1200, the trainer's 128-px buckets) on demo/full's
# training lines, full-width hctr in bf16 with f32 parameters, dropout on
FULL_MODEL, FULL_DATA = "hctr", "demo/full/data"
FULL_RECIPE = dict(batch_size=16, lr=5e-4, weight_decay=1e-4,
                   optimizer="adam", seed=42, max_width=1200,
                   bucket_step=128, workers=4)
FULL_STEPS = 30
FULL_TIMED_FROM = 10           # steps 11-30 are timed (past cuDNN's autotune)
FULL_REPLAYED = 10             # the last steps' batches, profiled and remat
# train_cli: the JAX CLI's test accuracy on the same command on the CPU at
# seeds 0, 1 and 2, warm-started from the same weights
# (tools/train_cli_reference.py --seed 0 1 2, which strips
# demo/hard/checkpoint to its weights first: -re on the full checkpoint
# resumes at epoch 142)
JAX_CLI_ACC = {0: 0.9161, 1: 0.9138, 2: 0.9131}
# The rule: the two CLIs' means over the same seeds lie within the largest
# seed-to-seed range that one CLI showed in one setting. Over seeds 0-2
# (tools/train_cli_reference.py; PERF.md §6) the ranges were 0.0030
# (either CLI, CPU, bf16), 0.0068 (either CLI, CPU, f32), 0.0091 (the port,
# card, bf16) and 0.0129 (the port, card, f32): dropout masks from other
# generators and other bf16 roundings move one run that far
TRAIN_CLI_ACC_TOL = 0.0129
TRAIN_CLI_TIMEOUT = 600        # seconds for one run of the CLI
# demo/hard's text source (tools/make_hard_demo.py:79-97, copied below):
# 200 glyph classes in 100 confusable pairs, a sparse bigram chain over
# them; its LMs were trained on 8000 lines of default_rng(7) at seed 42
HARD_GROUPS = 100
HARD_VOCAB = [chr(0x4E00 + i) for i in range(2 * HARD_GROUPS)]
HARD_CHAIN_SEED, HARD_LM_SEED, HARD_LM_LINES = 42, 7, 8000


def successors(prev_k: int, seed: int):
    """The 4 allowed successor classes of ``prev_k`` and their
    probabilities (a copy of ``tools/make_hard_demo.successors``)."""
    crng = np.random.default_rng(seed * 77_777 + prev_k)
    groups = crng.choice(HARD_GROUPS, 4, replace=False)
    members = crng.integers(0, 2, 4)
    probs = crng.dirichlet(np.full(4, 1.5))
    return 2 * groups + members, probs


def sample_line(rng: np.random.Generator, seed: int,
                min_len=6, max_len=12) -> str:
    """One chain line (a copy of ``tools/make_hard_demo.sample_line``)."""
    L = int(rng.integers(min_len, max_len + 1))
    k = int(rng.integers(len(HARD_VOCAB)))
    out = [k]
    for _ in range(L - 1):
        succ, p = successors(out[-1], seed)
        out.append(int(rng.choice(succ, p=p)))
    return "".join(HARD_VOCAB[k] for k in out)

# export: bundles are written here (under build/, which git ignores) and
# removed after each phase
EXPORT_DIR = "build/chip_smoke_export"
EXPORT_MODEL = "hctr"
LM_EXPORT_BATCHES, LM_EXPORT_LENGTHS = (1, 10), (32, 64)
LM_EXPORT_TOL = 1e-5           # exported LM vs LMScorer, a token, f32
INT8_CALIB = "demo/hard/data/test"
# lm_train: tools/make_hard_demo.train_lm's recipe; the port-trained LM
# serves demo/hard -ss -lp 0.8 -lb 0.0 at this CER or better (the
# JAX-trained LM: 0.0000); the mean NLL of both LMs on held-out lines of
# another seed
HARD_LM_RECIPE = dict(epochs=3, batch_size=64, max_len=64, d_model=128,
                      n_layers=3, warmup_steps=200, log_every=200)
HARD_LM_CER_TOL = 0.005
HARD_LM_HELDOUT, HARD_LM_HELDOUT_SEED = 500, 8
# char-512x6 train steps timed at b64, L 160, bf16 (after LM_WARM_STEPS)
LM_TIMED_B, LM_TIMED_L, LM_TIMED_STEPS, LM_WARM_STEPS = 64, 160, 20, 3


def hard_corpus(n: int = HARD_LM_LINES, seed: int = HARD_LM_SEED) -> list:
    """The chain lines demo/hard's LMs were trained on
    (``tools/make_hard_demo.train_lm`` and ``train_ngram``)."""
    rng = np.random.default_rng(seed)
    return [sample_line(rng, HARD_CHAIN_SEED) for _ in range(n)]


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def text_lines(n: int, seed: int, height: int = 128,
               widths=(300, 1600)) -> list:
    """Seeded uint8 text-line images: white, with dark glyph-like bars."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = int(rng.integers(widths[0], widths[1] + 1))
        img = np.full((height, w), 255, dtype=np.uint8)
        x = int(rng.integers(4, 24))
        while x < w - 8:
            gw = int(rng.integers(12, 40))
            for _ in range(int(rng.integers(2, 7))):
                y0 = int(rng.integers(16, height - 24))
                x0 = x + int(rng.integers(0, gw // 2))
                img[y0:y0 + int(rng.integers(3, 9)),
                    x0:x0 + int(rng.integers(4, gw))] = int(rng.integers(0, 90))
            x += gw + int(rng.integers(2, 16))
        out.append(img)
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, with a cold L2. Each call is queued
    behind a spin kernel and a write of twice the L2's size, so the events
    around it time the card's work and not the host's launch of it; the
    spin doubles until the host has queued the call before the card gets
    to it."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    spin, times = SPIN_CYCLES, []
    while len(times) < reps:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        flush.zero_()
        s.record()
        fn()
        queued_in_time = not s.query()
        e.record()
        e.synchronize()
        if queued_in_time:
            times.append(s.elapsed_time(e))
        else:
            check(spin < SPIN_CYCLES * 2 ** 8, "device_ms: the host never "
                  "queued the call before the card reached it")
            spin *= 2
    return statistics.median(times)


def compare_k1(x: torch.Tensor, k: int = SEARCH_DEPTH) -> float:
    """K1 against its plain version on the same card tensor; returns the
    largest |difference| of vals and blank (equal infinities count as 0)."""
    got = k1.topk_logsoftmax(x, k=k)
    want = k1.topk_logsoftmax_plain(x, k=k)
    torch.cuda.synchronize()
    vals, idx, blank, n_above = got
    pv, pi, pb, pn = want
    what = (tuple(x.shape), str(x.dtype), k)
    check(torch.equal(idx, pi), f"K1 idx differs at {what}")

    def diff(a, b):
        return torch.where(a == b, 0.0, (a - b).abs()).max().item()
    err = max(diff(vals, pv), diff(blank, pb))
    check(err <= K1_TOL, f"K1 vals/blank differ by {err} at {what}")
    # rows with a class within K1_TOL of the prune threshold may count it
    # either way
    logp = torch.log_softmax(x.float(), dim=-1)
    edge = ((logp - k1.PRUNE).abs() <= K1_TOL).any(-1)
    check(torch.equal(n_above[~edge], pn[~edge]),
          f"K1 n_above differs at {what}")
    return err


def k1_bound(x: torch.Tensor, k: int):
    """(bound ms, bound by) of K1: each logit read once, vals and idx, blank
    and n_above written once; K1_OPS_PER_LOGIT f32 operations a logit."""
    D = x.shape[-1]
    rows = x.numel() // D
    return bound_ms(x.numel() * x.element_size() + rows * k * 8 + rows * 8,
                    rows * D * K1_OPS_PER_LOGIT, F32_OPS_PER_S)


def k1_time(x: torch.Tensor, k: int = SEARCH_DEPTH) -> dict:
    """K1 timed by ``device_ms`` beside its plain version, its bound and the
    library call ``topk(log_softmax(x))``."""
    bms, by = k1_bound(x, k)
    return {"shape": list(x.shape), "dtype": str(x.dtype), "k": k,
            "ms": device_ms(lambda: k1.topk_logsoftmax(x, k=k)),
            "plain_ms": device_ms(lambda: k1.topk_logsoftmax_plain(x, k=k)),
            "library_ms": device_ms(lambda: torch.topk(
                torch.log_softmax(x.float(), dim=-1), k, dim=-1)),
            "bound_ms": bms, "bound_by": by}


def k1_times(dev) -> dict:
    """K1 in f32 at the shapes of ``K1_SHAPES`` (K = 10), at the first of
    them also with K = 1 (the top-K's share), K = 32 (the fast path's
    largest) and K = 33 (the general path), and there the time of a plain
    streaming read of the logits (``amax`` over the class axis), which
    bounds what a kernel that reads them once reaches under ``device_ms``."""
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for B, T in K1_SHAPES:
        x = torch.randn((B, T, K1_CLASSES), device=dev, generator=g)
        out[f"{B}x{T}"] = k1_time(x)
        if (B, T) == K1_SHAPES[0]:
            for k in (1, 32, 33):
                out[f"{B}x{T}_k{k}"] = k1_time(x, k)
            out["amax_ms"] = device_ms(lambda: x.amax(-1))
    return out


def k1_cases(dev) -> list:
    """(logits, K) edge cases of K1, f32; every one is checked in bf16 too."""
    g = torch.Generator(device=dev).manual_seed(0)
    D = K1_CLASSES

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    # ties: values on a coarse grid repeat the maximum within most rows, and
    # the first rows of each sample are constant
    ties = torch.randint(0, 6, (4, 256, D), device=dev, generator=g).float()
    ties[:, :8] = 1.5
    # -inf: each row keeps 5 finite classes at random places
    neg = randn(2, 8, 300)
    keep = torch.rand((2, 8, 300), device=dev, generator=g).argsort(-1) < 5
    neg[~keep] = -float("inf")
    wide_neg = randn(1, 4, D)
    wide_neg[..., 7:] = -float("inf")
    cases = [
        (randn(*K1_SHAPES[0], D), SEARCH_DEPTH),
        (randn(3, 1600, D), SEARCH_DEPTH),
        (ties, SEARCH_DEPTH), (ties[:1, :64], 20),
        (randn(1, 9, D), SEARCH_DEPTH),          # every row alignment
        (randn(3, 5, D)[1:], SEARCH_DEPTH),      # data_ptr 12 bytes off 16
        (randn(2, 9, 20), 5), (randn(2, 3, 1), 1),
        (randn(2, 5, 16), 16), (randn(2, 5, 40), 40),    # K = D
        (randn(4, 64, D), 33), (randn(2, 8, D), 64),     # general path
        (torch.full((2, 4, D), 0.25, device=dev), SEARCH_DEPTH),  # all tie
        (torch.full((1, 3, 50), 0.25, device=dev), 50),
        (neg, 10), (neg, 20), (wide_neg, SEARCH_DEPTH), (wide_neg, 30),
    ]
    return cases


def k1_errors(dev) -> tuple:
    """K1 held against its plain version on the edge cases (f32 and bf16,
    fast and general path); returns the largest error and the bf16 time at
    the first shape of ``K1_SHAPES``."""
    before = dict(k1.launches_by_path)
    errs = []
    for x, k in k1_cases(dev):   # and in bf16 from the same values
        errs.append(max(compare_k1(x, k), compare_k1(x.bfloat16(), k)))
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((3, 9, K1_CLASSES), device=dev, generator=g).bfloat16()
    errs.append(compare_k1(x[1:], SEARCH_DEPTH))  # data_ptr 14 bytes off 16
    for path in ("fast", "general"):
        check(k1.launches_by_path[path] > before[path],
              f"K1's {path} path never launched")
    x = torch.randn((*K1_SHAPES[0], K1_CLASSES), device=dev, generator=g)
    return max(errs), k1_time(x.bfloat16())


def phase_kernels(dev, times: dict | None = None):
    """K1 timed at the shapes of ``K1_SHAPES`` (unless ``times`` were taken
    already) and held against its plain version on edge cases."""
    times = times or k1_times(dev)
    err, bf16 = k1_errors(dev)
    emit({"phase": "kernels", "max_abs_err": err, "bf16": bf16, **times})
    return err, times["x".join(map(str, K1_SHAPES[0]))]


def recognizer():
    """The full-width ``hctr`` (bf16 compute) with seeded weights."""
    model, characters = get_model_info("hctr", chars_list_file=CHARS_LIST,
                                       dtype=torch.bfloat16)
    codec = CTCCodec(characters)
    check(codec.num_classes == 7375, f"{codec.num_classes} classes")
    return model, codec, seeded_state_dict(model, 0)


def phase_serve(dev: torch.device, model, codec, state):
    n_params = sum(p.numel() for p in model.parameters())
    images = text_lines(N_REQUESTS, seed=0)

    # f32 reference on a small input: card vs CPU, same weights
    probe = torch.from_numpy(images[0][:, :64].astype(np.float32))
    probe = ((probe - 127.5) / 127.5)[None, :, :, None]
    ref, _ = get_model_info("hctr", chars_list_file=CHARS_LIST)
    ref.load_state_dict(state)
    ref.eval()
    with torch.inference_mode():
        want = ref(probe)
    ref.to(dev)
    with torch.inference_mode():
        got = ref(probe.to(dev)).cpu()
    del ref
    fwd_err = (got - want).abs().max().item()
    check(fwd_err <= FWD_TOL * max(1.0, want.abs().max().item()),
          f"f32 forward card vs CPU differs by {fwd_err}")

    greedy = ServingEngine(model, state, codec, widths=WIDTHS,
                           decode_method="greedy-search", device=dev)
    beam = ServingEngine(model, state, codec, widths=WIDTHS,
                         decode_method="beam-search",
                         search_depth=SEARCH_DEPTH, device=dev)
    for w in WIDTHS:  # forward warm-up per bucket shape (launches no K1)
        greedy.infer_batch(np.full((BATCH, 128, w, 1), 255, np.uint8))

    def serve(engine):
        # all requests are queued well inside the deadline, so each bucket
        # flushes in FIFO batches of BATCH; closing drains the partial ones
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ServingDaemon(engine, batch_size=BATCH,
                           max_delay_ms=500.0) as daemon:
            futs = [daemon.submit_array(a) for a in images]
        texts = [f.result() for f in futs]
        return texts, N_REQUESTS / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats(dev)
    k1.launches = 0                       # ---- main path: both routes
    # the first daemon's dispatcher thread is the first thread to run the
    # model outside the main one (cuDNN and cuBLAS keep handles per thread),
    # so greedy is served twice: the second run is the one reported as
    # steady
    greedy_texts, greedy_lps_first = serve(greedy)
    greedy_again, greedy_lps = serve(greedy)
    after_greedy = k1.launches
    beam_texts, beam_lps = serve(beam)
    launches = k1.launches                # ---- end of main path
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    check(after_greedy == 0, f"greedy launched K1 {after_greedy} times")
    check(launches > 0, "the beam route never launched K1")
    check(greedy_again == greedy_texts, "greedy texts differ between runs")
    check(all(isinstance(t, str) for t in greedy_texts + beam_texts)
          and len(greedy_texts) == len(beam_texts) == N_REQUESTS,
          "served texts malformed")

    # the daemon's batches again, one by one: logits finite and shaped;
    # greedy on the card == greedy on the CPU; beam fed by K1 == beam fed by
    # the plain top-K; both == what the daemon served
    items = [greedy.preprocess_array(a) for a in images]
    by_bucket = {}
    for i, (w, _) in enumerate(items):
        by_bucket.setdefault(w, []).append(i)
    errs = []
    with torch.inference_mode():
        for w, idxs in sorted(by_bucket.items()):
            for s in range(0, len(idxs), BATCH):
                chunk = idxs[s:s + BATCH]
                rows = chunk + [chunk[-1]] * (BATCH - len(chunk))
                batch = np.concatenate([items[i][1] for i in rows])
                x = (torch.from_numpy(batch).to(dev).float() - 127.5) / 127.5
                logits = beam.model(x)
                check(tuple(logits.shape) == (BATCH, w, 7375)
                      and logits.dtype == torch.float32
                      and bool(torch.isfinite(logits).all()),
                      f"logits at width {w}: {tuple(logits.shape)}")
                n = len(chunk)
                gc, gl = greedy_decode_device(logits,
                                              unknown_id=codec.unknown_id)
                hc, hl = greedy_decode_device(logits.cpu(),
                                              unknown_id=codec.unknown_id)
                check(torch.equal(gc.cpu(), hc) and torch.equal(gl.cpu(), hl),
                      f"greedy card vs CPU differs at width {w}")
                check(codec.compact_to_texts(gc.cpu(), gl.cpu())[:n]
                      == [greedy_texts[i] for i in chunk],
                      f"greedy daemon texts differ at width {w}")
                errs.append(compare_k1(logits))
                pk, lk = beam_search_fused(logits, depth=SEARCH_DEPTH,
                                           unknown_id=codec.unknown_id,
                                           len_bonus=beam.route.len_bonus)
                v, c, _, _ = k1.topk_logsoftmax_plain(logits, k=SEARCH_DEPTH)
                pp, lp = beam_search_from_topk(
                    v, c, unknown_id=codec.unknown_id,
                    len_bonus=beam.route.len_bonus)
                check(torch.equal(lk, lp) and torch.equal(pk, pp),
                      f"beam with K1 vs the plain top-K differs at width {w}")
                check(codec.compact_to_texts(pk.cpu(), lk.cpu())[:n]
                      == [beam_texts[i] for i in chunk],
                      f"beam daemon texts differ at width {w}")
    emit({"phase": "serve", "model": "hctr", "params": n_params,
          "classes": codec.num_classes, "compute_dtype": "bfloat16",
          "requests": N_REQUESTS, "batch": BATCH, "widths": list(WIDTHS),
          "buckets": {str(w): len(v) for w, v in sorted(by_bucket.items())},
          "greedy_lines_per_s_first_daemon": greedy_lps_first,
          "greedy_lines_per_s": greedy_lps, "beam_lines_per_s": beam_lps,
          "peak_mem_mib": peak_mib, "k1_launches": launches,
          "f32_fwd_max_abs_err": fwd_err,
          "beam_chars_per_line": statistics.mean(len(t) for t in beam_texts)})
    phase_breakdown(beam, images, items)
    return launches, max(errs)


def phase_breakdown(engine: ServingEngine, images, items) -> None:
    """Where one batch's time goes: CUDA-event medians of each stage of the
    two routes on a batch of the served images at the widest bucket, and
    of the forward at every bucket width; host-clock times of the host
    stages (preprocessing one image, the D2H copy and string join of a
    greedy batch)."""
    t0 = time.perf_counter()
    for a in images:
        engine.preprocess_array(a)
    prep_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    w = WIDTHS[-1]
    rows = [x for bw, x in items if bw == w] or [items[0][1]]
    batch = np.concatenate((rows * BATCH)[:BATCH])
    dev = engine.device
    unk = engine.codec.unknown_id
    with torch.inference_mode():
        u8 = torch.from_numpy(batch)
        h2d_ms = cuda_ms(lambda: u8.to(dev))
        fwd_ms = {}
        for bw in WIDTHS:
            xw = (u8[:, :, :bw].to(dev).float() - 127.5) / 127.5
            fwd_ms[str(bw)] = cuda_ms(lambda: engine.model(xw))
        x = (u8.to(dev).float() - 127.5) / 127.5
        logits = engine.model(x)
        greedy_ms = cuda_ms(lambda: greedy_decode_device(logits,
                                                         unknown_id=unk))
        k1_ms = cuda_ms(lambda: k1.topk_logsoftmax(logits, k=SEARCH_DEPTH))
        chars, lengths = greedy_decode_device(logits, unknown_id=unk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.codec.compact_to_texts(chars.cpu().numpy(),
                                      lengths.cpu().numpy())
        join_ms = (time.perf_counter() - t0) * 1e3
        v, c, _, _ = k1.topk_logsoftmax(logits, k=SEARCH_DEPTH)
        beam_ms = cuda_ms(lambda: beam_search_from_topk(
            v, c, beam_size=engine.route.beam_size, unknown_id=unk,
            len_bonus=engine.route.len_bonus), reps=3, warmup=1)
    emit({"phase": "breakdown", "batch": BATCH, "width": w,
          "preprocess_ms_per_image": prep_ms, "d2h_and_join_ms": join_ms,
          "h2d_ms": h2d_ms, "forward_ms_by_width": fwd_ms,
          "greedy_decode_ms": greedy_ms, "k1_ms": k1_ms,
          "beam_search_ms": beam_ms})


# ------------------------------------------------------------ K2, K3, K4
def bound_ms(bytes_moved: float, ops: float, ops_per_s: float):
    """The least time for the work: bytes over the HBM rate or operations
    over the peak rate of their type, whichever is longer."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def k2_inputs(dev, g, B, N, L, dtype=torch.bfloat16):
    """Pre-scaled queries and a cache; beam 0 has an empty cache and beam 1
    a full one."""
    H, Dh = LM_HEADS, LM_DHEAD
    q = (torch.randn((B, N, H, Dh), device=dev, generator=g)
         / Dh ** 0.5).to(dtype)
    k = torch.randn((B, L, H, Dh), device=dev, generator=g).to(dtype)
    v = torch.randn((B, L, H, Dh), device=dev, generator=g).to(dtype)
    lengths = torch.randint(1, L + 1, (B,), device=dev, generator=g,
                            dtype=torch.int32)
    lengths[0], lengths[1] = 0, L
    return q, k, v, lengths


def k2_deep_inputs(dev, g, dtype):
    """A 512-position cache (the largest ``STABLE_CTX``) with lengths at
    the edges of the kernel's 64-key tiles: empty, 1, 63, 64, 65, 129 and
    full, then random; 37 queries (not a multiple of 16)."""
    q, k, v, _ = k2_inputs(dev, g, 10, 37, 512, dtype)
    lengths = torch.tensor([0, 1, 63, 64, 65, 129, 512, 200, 311, 450],
                           dtype=torch.int32, device=dev)
    return q, k, v, lengths


def k2_trained_inputs(g, B, N, L):
    """The served frame's shapes at the depth trained serving gives K2:
    lines of 40-50 characters, so caches 40-50 deep (uniform)."""
    dev = g.device
    q, k, v, _ = k2_inputs(dev, g, B, N, L)
    lengths = torch.randint(40, 51, (B,), device=dev, generator=g,
                            dtype=torch.int32)
    return q, k, v, lengths


def k2_bound(q, k, lengths):
    """(bound ms, bound by) of K2: q, the valid k and v rows read once, o,
    m and l written once; 4 Dh operations per (query, valid key) pair."""
    B, N, H, Dh = q.shape
    valid = int(lengths.clamp(0, k.shape[1]).sum())
    es = q.element_size()
    return bound_ms(q.numel() * es + 2 * valid * H * Dh * es
                    + B * N * H * Dh * 4 + 2 * B * N * H * 4 + B * 4,
                    4 * Dh * N * H * valid, BF16_OPS_PER_S)


def compare_k2(q, k, v, lengths) -> float:
    """K2 against its plain version; returns the largest |difference| of
    o, m and l."""
    (o, m, l), (po, pm, pl) = (k2.peek_cache_attention(q, k, v, lengths),
                               k2.peek_cache_attention_plain(q, k, v,
                                                             lengths))
    torch.cuda.synchronize()
    shape = (tuple(q.shape), tuple(k.shape), str(q.dtype))
    e_o, e_l = rel_err(o, po), rel_err(l, pl)
    e_m = (m - pm).abs().max().item()
    check(e_o <= K2_REL_TOL and e_l <= K2_REL_TOL and e_m <= K2_M_TOL,
          f"K2 differs at {shape}: o rel {e_o}, l rel {e_l}, m {e_m}")
    empty = lengths == 0
    check(bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
               and (o[empty] == 0).all()),
          f"K2 empty cache is not m = -1e30, l = 0, o = 0 at {shape}")
    return max((o - po).abs().max().item(), e_m, (l - pl).abs().max().item())


def compare_k3(x, emb) -> float:
    got, want = k3.lse_rows(x, emb), k3.lse_rows_plain(x, emb)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(tuple(got.shape) == tuple(x.shape[:-1]) and err <= K3_TOL,
          f"K3 differs by {err} at {tuple(x.shape)} x {tuple(emb.shape)}")
    return err


def compare_k4(ck, cv, idx, kn, vn, wpos) -> float:
    got = k4.gather_write_kv(ck, cv, idx, kn, vn, wpos)
    want = k4.gather_write_kv_plain(ck, cv, idx, kn, vn, wpos)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    check(err <= K4_TOL, f"K4 differs by {err} at {tuple(ck.shape)}")
    return err


def k4_inputs(dev, g, B, L, dtype=torch.bfloat16):
    """A cache of B beams; beams 0 and 1 share a parent, and the write
    positions include 0, L and past L."""
    shape = (LM_LAYERS, B, L, LM_HEADS, LM_DHEAD)
    ck = torch.randn(shape, device=dev, generator=g).to(dtype)
    cv = torch.randn(shape, device=dev, generator=g).to(dtype)
    kn = torch.randn((LM_LAYERS, B, LM_HEADS, LM_DHEAD), device=dev,
                     generator=g).to(dtype)
    vn = torch.randn_like(kn)
    idx = torch.randint(0, B, (B,), device=dev, generator=g,
                        dtype=torch.int32)
    idx[1] = idx[0]
    wpos = torch.randint(0, L, (B,), device=dev, generator=g,
                         dtype=torch.int32)
    wpos[0], wpos[2], wpos[3] = 0, L, L + 5
    return ck, cv, idx, kn, vn, wpos


def k4_library(ck, cv, idx, kn, vn, wpos):
    """One PyTorch call pair computing K4's function: ``index_select`` of
    the parents and ``index_put_`` of the new rows."""
    L = ck.shape[2]
    ok_rows = torch.nonzero(wpos < L)[:, 0]
    ok_pos = wpos[ok_rows].long()
    idx_l = idx.long()
    lay = torch.arange(ck.shape[0], device=ck.device)[:, None]

    def library():
        ok = ck.index_select(1, idx_l)
        ov = cv.index_select(1, idx_l)
        ok.index_put_((lay, ok_rows[None], ok_pos[None]), kn[:, ok_rows])
        ov.index_put_((lay, ok_rows[None], ok_pos[None]), vn[:, ok_rows])
        return ok, ov
    return library


def lm_kernel_times(served: dict, deep) -> dict:
    """K2 (on the served frame and at trained depth, ``deep``), K3 and K4
    timed by ``device_ms`` beside their plain versions, their bounds and,
    where one PyTorch call computes the same, that call."""
    out = {}
    q, k, v, lengths = served["peek_cache_attention"]
    L = k.shape[1]
    for name, (tq, tk, tv, tl) in (("peek_cache_attention",
                                    (q, k, v, lengths)),
                                   ("peek_cache_attention_trained_depth",
                                    deep)):
        bms, by = k2_bound(tq, tk, tl)
        out[name] = dict(
            bound_ms=bms, bound_by=by,
            ms=device_ms(lambda: k2.peek_cache_attention(tq, tk, tv, tl)),
            plain_ms=device_ms(
                lambda: k2.peek_cache_attention_plain(tq, tk, tv, tl)),
            library_ms=None,
            shape={"q": list(tq.shape), "kv": list(tk.shape),
                   "valid_cache_rows": int(tl.clamp(0, L).sum())})

    x, emb = served["lse_rows"]
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    V = emb.shape[0]
    bms, by = bound_ms((rows + V) * d * x.element_size() + rows * 4,
                       2 * rows * V * d, BF16_OPS_PER_S)
    out["lse_rows"] = dict(
        bound_ms=bms, bound_by=by,
        ms=device_ms(lambda: k3.lse_rows(x, emb)),
        plain_ms=device_ms(lambda: k3.lse_rows_plain(x, emb)),
        library_ms=device_ms(
            lambda: torch.logsumexp(x.float() @ emb.float().T, -1)),
        shape={"x": list(x.shape), "emb": [V, d]})

    ck, cv, idx, kn, vn, wpos = served["gather_write_kv"]
    n_lay, B, L = ck.shape[:3]
    row = ck[0, 0, 0].numel() * ck.element_size()
    parents = int(torch.unique(idx).numel())
    written = int((wpos < L).sum())
    bms, by = bound_ms(2 * n_lay * (parents * L + B * L) * row
                       + 2 * n_lay * written * row + 8 * B, 0,
                       BF16_OPS_PER_S)
    out["gather_write_kv"] = dict(
        bound_ms=bms, bound_by=by,
        ms=device_ms(lambda: k4.gather_write_kv(ck, cv, idx, kn, vn, wpos)),
        plain_ms=device_ms(
            lambda: k4.gather_write_kv_plain(ck, cv, idx, kn, vn, wpos)),
        library_ms=device_ms(k4_library(ck, cv, idx, kn, vn, wpos)),
        shape={"cache": list(ck.shape), "distinct_parents": parents,
               "rows_written": written})
    return out


def lm_kernel_errors(dev, served: dict, deep) -> dict:
    """K2, K3 and K4 held against their plain versions on the served
    frame's inputs, K2 at trained depth (``deep``), and edge cases; the
    largest error of each."""
    g = torch.Generator(device=dev).manual_seed(2)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    # K3: the served frame; rows not a multiple of the row tile, V not a
    # multiple of the vocabulary tile (7377, 130; 129 leaves a one-entry
    # range), small d, a bf16 d that only the SIMT path takes, and f32
    # (the SIMT path)
    x, emb = served["lse_rows"]
    d = x.shape[-1]
    e_k3 = max(compare_k3(x, emb), compare_k3(rand(37, d), emb),
               compare_k3(rand(37, 48), rand(130, 48)),
               compare_k3(rand(5, 64), rand(129, 64)),
               compare_k3(rand(7, 36), rand(300, 36)),
               compare_k3(rand(2, 3, 96, dtype=torch.float32),
                          rand(777, 96, dtype=torch.float32)),
               compare_k3(x.float(), emb.float()))

    # K4: the served frame's commit; repeated parents, wpos 0 / L / past L
    # and the identity with no write at the served shapes; f32
    ck, cv, idx, kn, vn, wpos = served["gather_write_kv"]
    B, L = ck.shape[1:3]
    e_k4 = max(compare_k4(ck, cv, idx, kn, vn, wpos),
               compare_k4(*k4_inputs(dev, g, B, L)),
               compare_k4(*k4_inputs(dev, g, 5, 9, torch.float32)))
    ident = torch.arange(B, device=dev, dtype=torch.int32)
    got = k4.gather_write_kv(ck, cv, ident, kn, vn, torch.full_like(wpos, L))
    check(torch.equal(got[0], ck) and torch.equal(got[1], cv),
          "K4 identity reorder without a write changed the cache")
    lib = k4_library(ck, cv, idx, kn, vn, wpos)()
    plain = k4.gather_write_kv_plain(ck, cv, idx, kn, vn, wpos)
    check(torch.equal(lib[0], plain[0]) and torch.equal(lib[1], plain[1]),
          "the K4 library yardstick computes another function")

    # K2: the served frame (layer 0), trained depth, random lengths at the
    # served shapes; f32 and ragged N; L = 512 in bf16 and f32 with lengths
    # at the 64-key tile edges, an empty and a full cache
    q, k, v, lengths = served["peek_cache_attention"]
    B, N = q.shape[:2]
    L = k.shape[1]
    e_k2 = max(compare_k2(q, k, v, lengths), compare_k2(*deep),
               compare_k2(*k2_inputs(dev, g, B, N, L)),
               compare_k2(*k2_inputs(dev, g, 6, 10, 17, torch.float32)),
               compare_k2(*k2_inputs(dev, g, 3, 5, 7)),
               compare_k2(*k2_deep_inputs(dev, g, torch.bfloat16)),
               compare_k2(*k2_deep_inputs(dev, g, torch.float32)))
    return {"peek_cache_attention": e_k2,
            "peek_cache_attention_trained_depth": e_k2,
            "lse_rows": e_k3, "gather_write_kv": e_k4}


def phase_lm_kernels(dev, served: dict, times_first: bool = False):
    """K2, K3 and K4 on the inputs each got at one frame of the served LM
    route (``served``, from ``record_frame``), K2 also at trained depth:
    held against their plain versions there and on edge cases, then timed.
    With ``times_first`` the times come first, on a line of their own, so
    that a kernel that fails an edge case is still timed."""
    q, k = served["peek_cache_attention"][:2]
    deep = k2_trained_inputs(torch.Generator(device=dev).manual_seed(4),
                             *q.shape[:2], k.shape[1])
    if times_first:
        times = lm_kernel_times(served, deep)
        emit({"phase": "lm_kernel_times", "frame": served["frame"],
              "ctx": k.shape[1], **times})
        errs = lm_kernel_errors(dev, served, deep)
    else:
        errs = lm_kernel_errors(dev, served, deep)
        times = lm_kernel_times(served, deep)
    out = {name: {"max_abs_err": errs[name], **t}
           for name, t in times.items()}
    one = torch.zeros(1, device=dev)
    emit({"phase": "lm_kernels", "frame": served["frame"], "ctx": k.shape[1],
          # the least time device_ms reports: one one-element kernel
          "device_ms_floor": device_ms(one.zero_), **out})
    return out


def synthetic_frame(dev) -> dict:
    """K2-K4 inputs at the served frame's shapes (``record_frame``) from a
    seed, for ``--kernels``: caches a few tokens deep, as a seeded LM
    keeps them."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, ctx, d = LM_BEAMS, 144, LM_HEADS * LM_DHEAD
    q, k, v, _ = k2_inputs(dev, g, B, LM_ROWS * LM_SC, ctx)
    lengths = torch.randint(0, 9, (B,), device=dev, generator=g,
                            dtype=torch.int32)
    x = torch.randn((B, LM_ROWS, LM_SC - 1, d), device=dev,
                    generator=g).to(torch.bfloat16)
    emb = (torch.randn((LM_VOCAB, d), device=dev, generator=g)
           / d ** 0.5).to(torch.bfloat16)
    return {"frame": "synthetic", "peek_cache_attention": (q, k, v, lengths),
            "lse_rows": (x, emb), "gather_write_kv": k4_inputs(dev, g, B, ctx)}


# --------------------------------------------------------- LM-fused route
def launch_counts() -> dict:
    return {"topk_logsoftmax": k1.launches, "peek_cache_attention":
            k2.launches, "lse_rows": k3.launches,
            "gather_write_kv": k4.launches}


@contextlib.contextmanager
def plain_kernels():
    """K1-K4 swapped for their plain versions on the card (every caller
    reaches them through their module); no kernel may launch meanwhile."""
    swaps = [(k1, "topk_logsoftmax", k1.topk_logsoftmax_plain),
             (k2, "peek_cache_attention", k2.peek_cache_attention_plain),
             (k3, "lse_rows", k3.lse_rows_plain),
             (k4, "gather_write_kv", k4.gather_write_kv_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    before = launch_counts()
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    check(launch_counts() == before, "a kernel launched in the plain run")


def nth_call(n: int):
    """A ``record_first`` condition that holds at the ``n``-th call (from
    0) of the kernel it is given to."""
    calls = [0]

    def at(args):
        calls[0] += 1
        return calls[0] == n + 1
    return at


@contextlib.contextmanager
def record_frame(frame: int):
    """Keep clones of the inputs K2, K3 and K4 get at search frame ``frame``
    of the next full-search decode: K2 at layer 0, K3 and K4 at their one
    call per frame. Yields the dict they are kept in."""
    with record_first({"peek_cache_attention": nth_call(LM_LAYERS * frame),
                       "lse_rows": nth_call(frame),
                       "gather_write_kv": nth_call(frame)}) as kept:
        kept["frame"] = frame
        yield kept


def searched_frames(logits: torch.Tensor, unknown_id: int,
                    group: int) -> int:
    """Frames the full search runs for a batch, from the greedy line alone:
    per group of lines, the largest last-greedy-character frame + 4."""
    arg = logits.argmax(-1).cpu().numpy()
    B, T = arg.shape
    ends = []
    for b in range(B):
        prev = np.concatenate([[-1], arg[b, :-1]])
        keep = (arg[b] != 0) & (arg[b] != unknown_id) & (arg[b] != prev)
        ends.append(min(int(np.nonzero(keep)[0][-1]) + 4, T)
                    if keep.any() else 0)
    return sum(max(ends[s:s + group]) for s in range(0, B, group))


def selection_trace(engine: ServingEngine, logits: torch.Tensor) -> list:
    """The batch's search run again at the engine's current sizing, each
    step's selection recorded: ``[(step, totals, parents, chars)]``, (G, BM)
    tensors of each group in rank order."""
    beam, trace = engine._lm_beam, []
    cv, ci, blank_lp, n_above = k1.topk_logsoftmax(
        logits, k=SEARCH_DEPTH, prune=engine._prune_lp)
    logz = torch.logsumexp(logits.float(), dim=-1)
    args = (cv, ci, logits, logz) + ((blank_lp, n_above) if beam.skip
                                     else ())
    beam.search(beam.last_group, on_select=lambda t, tot, par, ch: trace.append(
        (t, tot.clone(), par.clone(), ch.clone())))(*args)
    return trace


def first_divergence(engine: ServingEngine, logits: torch.Tensor) -> dict:
    """Run the batch's search twice, with the kernels and with the plain
    versions, recording every step's selection; return the first step, line
    and rank where the two runs selected differently, with the two totals
    there, and ``noise``: the largest difference between the two runs'
    totals of the same hypothesis (parent and character) at that step and
    the steps before it, what the kernels' rounding has moved a total
    by."""
    runs = []
    for ctx in (contextlib.nullcontext, plain_kernels):
        with ctx():
            runs.append(selection_trace(engine, logits))
    noise = 0.0
    for (t, tot_k, par_k, ch_k), (_, tot_p, par_p, ch_p) in zip(*runs):
        for g in range(tot_k.shape[0]):
            kern = {(int(p), int(c)): float(x) for p, c, x in
                    zip(par_k[g], ch_k[g], tot_k[g]) if x > -5e29}
            for p, c, x in zip(par_p[g], ch_p[g], tot_p[g]):
                if x > -5e29 and (int(p), int(c)) in kern:
                    noise = max(noise,
                                abs(kern[(int(p), int(c))] - float(x)))
        differ = (par_k != par_p) | (ch_k != ch_p)
        if bool(differ.any()):
            g, r = (int(i) for i in torch.nonzero(differ)[0])
            a, b = float(tot_k[g, r]), float(tot_p[g, r])
            return {"step": t, "line_in_group": g, "rank": r,
                    "kernel_total": a, "plain_total": b, "diff": abs(a - b),
                    "noise": noise}
    raise AssertionError("texts differ but no selection differs")


def seeded_lm(codec) -> TorchLMBackend:
    """The full-width char-512x6 LM with random weights from ``LM_SEED``."""
    lm = TorchLMBackend(*load_lm(f"seed:{LM_SEED}",
                                 chars_list="".join(codec.chars_list)))
    cfg = lm.lm_model.config()
    check(cfg["vocab_size"] == LM_VOCAB
          and cfg["d_model"] == LM_HEADS * LM_DHEAD
          and cfg["n_layers"] == LM_LAYERS and cfg["max_len"] == LM_CTX,
          f"LM config {cfg}")
    return lm


def serve_lm_route(dev, model, codec, state, lm, what: str, on_batch,
                   **engine_kw) -> dict:
    """The LM route's 8 seeded lines of width <= 128 through ServingDaemon
    at batch 4 (the main path: launch counts set to 0 just before, read
    just after), then each of the daemon's batches (one bucket, FIFO)
    decoded again: with the kernels, which must give the served texts, and
    with the plain versions, which must give the same texts but for
    near-ties within 1e-5, reported. ``on_batch(s, engine, logits)`` counts
    what the caller's checks need and returns a context for the kernel
    decode, whose value is kept as ``recorded``."""
    engine = ServingEngine(model, state, codec, widths=(LM_WIDTH,),
                           decode_method="beam-search",
                           search_depth=SEARCH_DEPTH, lm=lm,
                           use_lm_pred=True, use_lm_score=True, device=dev,
                           **engine_kw)
    images = text_lines(LM_REQUESTS, seed=LM_SEED, widths=(64, LM_WIDTH))
    with torch.inference_mode():  # forward warm-up at the bucket shape
        engine.model(torch.zeros((BATCH, 128, LM_WIDTH, 1), device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()              # ---- main path
    t0 = time.perf_counter()
    with ServingDaemon(engine, batch_size=BATCH, max_delay_ms=500.0) as d:
        futs = [d.submit_array(a) for a in images]
    texts = [f.result() for f in futs]
    lps = LM_REQUESTS / (time.perf_counter() - t0)
    counts = launch_counts()      # ---- end of main path
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    check(all(isinstance(t, str) for t in texts) and len(texts)
          == LM_REQUESTS, f"{what} texts malformed")
    items = [engine.preprocess_array(a) for a in images]
    check(all(w == LM_WIDTH for w, _ in items), "LM lines left the bucket")
    batches, divergences, recorded = 0, [], None
    with torch.inference_mode():
        for s in range(0, LM_REQUESTS, BATCH):
            chunk = list(range(s, min(s + BATCH, LM_REQUESTS)))
            rows = chunk + [chunk[-1]] * (BATCH - len(chunk))
            batch = np.concatenate([items[i][1] for i in rows])
            x = (torch.from_numpy(batch).to(dev).float() - 127.5) / 127.5
            logits = engine.model(x)
            check(tuple(logits.shape) == (BATCH, LM_WIDTH, codec.num_classes)
                  and bool(torch.isfinite(logits).all()),
                  f"{what} logits {tuple(logits.shape)}")
            batches += 1
            with on_batch(s, engine, logits) as rec:
                got = engine.decode_logits(logits)[:len(chunk)]
            recorded = recorded if rec is None else rec
            check(got == [texts[i] for i in chunk],
                  f"{what}: daemon texts differ from a re-decode")
            with plain_kernels():
                want = engine.decode_logits(logits)[:len(chunk)]
            if got != want:
                div = first_divergence(engine, logits)
                div["lines"] = [i for i, a, b in zip(chunk, got, want)
                                if a != b]
                divergences.append(div)
                emit({"phase": f"{what}_divergence", **div})
                check(div["diff"] < NEAR_TIE,
                      f"{what}: kernels and plain versions decode "
                      f"differently beyond a near-tie: {div}")
    beam = engine._lm_beam
    check(beam.last_group == BATCH and beam._ctx <= LM_CTX,
          f"group {beam.last_group}, ctx {beam._ctx}")
    return {"engine": engine, "texts": texts, "lines_per_s": lps,
            "counts": counts, "peak_mem_mib": peak_mib, "batches": batches,
            "divergences": divergences, "logits": logits,
            "recorded": recorded}


def phase_serve_lm(dev, model, codec, state):
    """The LM-fused full search: full hctr and the full-width char LM (both
    bf16, seeded) on the LM route's lines."""
    lm = seeded_lm(codec)
    cfg = lm.lm_model.config()
    frames = []

    def on_batch(s, engine, logits):
        frames.append(searched_frames(logits, codec.unknown_id,
                                      engine._lm_beam.last_group))
        # keep one served frame's K2-K4 inputs
        return record_frame(frames[0] // 2) if s == 0 else \
            contextlib.nullcontext()

    run = serve_lm_route(dev, model, codec, state, lm, "serve_lm", on_batch)
    counts, n, served = run["counts"], sum(frames), run["recorded"]
    check(n > 0 and counts["lse_rows"] == counts["gather_write_kv"] == n,
          f"K3/K4 launches {counts} vs {n} frames searched")
    check(counts["peek_cache_attention"] == LM_LAYERS * n,
          f"K2 launches {counts} vs {LM_LAYERS} x {n} frames")
    check(counts["topk_logsoftmax"] == run["batches"],
          f"K1 launches {counts} vs {run['batches']} LM batches")
    engine = run["engine"]
    ctx = engine._lm_beam._ctx
    emit({"phase": "serve_lm", "model": "hctr", "lm": "char-512x6",
          "lm_params": sum(t.numel() for t in lm.lm_params.values()),
          "lm_vocab": cfg["vocab_size"], "compute_dtype": "bfloat16",
          "requests": LM_REQUESTS, "batch": BATCH, "width": LM_WIDTH,
          "lines_per_s": run["lines_per_s"],
          "peak_mem_mib": run["peak_mem_mib"], "frames_searched": n,
          "lm_batches": run["batches"], "ctx": ctx,
          "group": engine._lm_beam.last_group, "launches": counts,
          "texts_equal_plain": not run["divergences"],
          "near_ties": len(run["divergences"]),
          "chars_per_line": statistics.mean(len(t) for t in run["texts"])})
    phase_lm_breakdown(engine, run["logits"], frames[-1])
    shapes = {name: [list(a.shape) for a in served[name]]
              for name in ("peek_cache_attention", "lse_rows",
                           "gather_write_kv")}
    d = LM_HEADS * LM_DHEAD
    check(shapes["peek_cache_attention"][:2]
          == [[LM_BEAMS, LM_ROWS * LM_SC, LM_HEADS, LM_DHEAD],
              [LM_BEAMS, ctx, LM_HEADS, LM_DHEAD]]
          and shapes["lse_rows"] == [[LM_BEAMS, LM_ROWS, LM_SC - 1, d],
                                     [LM_VOCAB, d]]
          and shapes["gather_write_kv"][0]
          == [LM_LAYERS, LM_BEAMS, ctx, LM_HEADS, LM_DHEAD],
          f"served kernel inputs at ctx {ctx}: {shapes}")
    return counts, served


# kernels of the port by the name the profiler gives them
_OWN = {"topk_logsoftmax_kernel": "topk_logsoftmax",
        "peek_": "peek_cache_attention", "lse_": "lse_rows",
        "gather_write_kernel": "gather_write_kv"}


def profile_decode(engine: ServingEngine, logits: torch.Tensor, wanted=None,
                   optional=()):
    """One decode under torch.profiler: ``(device busy ms, device ms of each
    of the port's kernels, kernel launches, the 12 largest kernels, the
    records of wanted``, see ``record_first``)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with (record_first(wanted, optional) if wanted else
              contextlib.nullcontext({})) as kept:
            engine.decode_logits(logits)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    own = {name: 0.0 for name in _OWN.values()}
    for key, ms, _ in kernels:
        for tag, name in _OWN.items():
            if tag in key:
                own[name] += ms
    return (sum(ms for _, ms, _ in kernels), own,
            sum(n for _, _, n in kernels), top_kernels(kernels), kept)


def device_kernels(prof) -> list:
    """``(name, device ms, launches)`` of each kernel in a profile."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def top_kernels(kernels: list) -> list:
    return [{"name": k[:90], "ms": ms, "count": n}
            for k, ms, n in sorted(kernels, key=lambda k: -k[1])[:12]]


def phase_lm_breakdown(engine: ServingEngine, logits: torch.Tensor,
                       frames: int) -> None:
    """Where one LM batch's time goes: the host clock around its decode
    (ended by a synchronize), and torch.profiler's device time by kernel
    over a second decode of the same batch. The idle share is 1 - device
    time / unprofiled wall time; with no device time in the trace it is
    reported as not measured."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_logits(logits)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, own, n_launch, top, _ = profile_decode(engine, logits)
    emit({"phase": "lm_breakdown", "batch": BATCH, "width": LM_WIDTH,
          "frames": frames, "wall_ms": wall_ms,
          "wall_ms_per_frame": wall_ms / max(frames, 1),
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "device_idle_share": (1 - busy_ms / wall_ms if busy_ms > 0
                                else "not measured"),
          "device_busy_ms_per_frame": (busy_ms / max(frames, 1)
                                       if busy_ms > 0 else "not measured"),
          "kernel_launches": n_launch, "own_kernels_ms": own,
          "own_kernels_share": {name: ms / busy_ms if busy_ms > 0
                                else "not measured"
                                for name, ms in own.items()},
          "top_kernels": top})


# ------------------------------------------------------ skip search (-ss)
def reset_launches() -> None:
    for mod in (k1, k2, k3, k4):
        mod.launches = 0


def k1_outputs(engine: ServingEngine, logits: torch.Tensor):
    return k1.topk_logsoftmax(logits, k=SEARCH_DEPTH, prune=engine._prune_lp)


def segments_stepped(engine: ServingEngine, logits: torch.Tensor) -> int:
    """Segments the skip search steps through for a batch (one search step
    and one K4 launch each): per group, the largest segment count of its
    lines, within the segment budget."""
    beam = engine._lm_beam
    _, ci, _, n_above = k1_outputs(engine, logits)
    segs = blm.count_segments(ci, n_above, unknown_id=engine.codec.unknown_id,
                              run_max=beam.run_max)
    B, T = n_above.shape
    budget = min(beam._budget, T)
    return sum(min(int(segs[s:s + beam.last_group].max()), budget)
               for s in range(0, B, beam.last_group))


def check_skip_counts(counts: dict, steps: int, batches: int,
                      what: str) -> None:
    """Launch counts of a skip-search main path: K1 once a batch, K4 once a
    segment step (the non-fused commit), K3 once a segment step and once a
    run phase, K2 once a layer for each K3."""
    check(counts["topk_logsoftmax"] == batches,
          f"{what}: K1 launches {counts} vs {batches} batches")
    check(steps > 0 and counts["gather_write_kv"] == steps,
          f"{what}: K4 launches {counts} vs {steps} segment steps")
    check(counts["lse_rows"] >= steps
          and counts["peek_cache_attention"] == LM_LAYERS * counts["lse_rows"],
          f"{what}: K2/K3 launches {counts} vs {steps} segment steps")


@contextlib.contextmanager
def record_first(wanted: dict, optional=()):
    """Wrap K1-K4 in their modules and keep clones of the first inputs for
    which ``wanted[name](args)`` holds (name: a key of ``launch_counts``,
    or ``name@tag`` for several shapes of one kernel); a call's keyword
    arguments, where it has any, are kept as a dict after its positional
    ones. Yields the dict they are kept in; every name not in ``optional``
    must have been recorded."""
    mods = {"topk_logsoftmax": k1, "peek_cache_attention": k2,
            "lse_rows": k3, "gather_write_kv": k4}
    saved = {base: getattr(mods[base], base)
             for base in {key.split("@")[0] for key in wanted}}
    kept = {}

    def recorder(base, fn):
        def rec(*args, **kw):
            for key, pred in wanted.items():
                if key.split("@")[0] == base and key not in kept \
                        and pred(args):
                    kept[key] = (tuple(a.clone() for a in args)
                                 + ((dict(kw),) if kw else ()))
            return fn(*args, **kw)
        return rec

    for base, fn in saved.items():
        setattr(mods[base], base, recorder(base, fn))
    try:
        yield kept
    finally:
        for base, fn in saved.items():
            setattr(mods[base], base, fn)
    check(set(wanted) - set(optional) <= set(kept),
          f"recorded only {sorted(kept)} of {sorted(wanted)}")


def phase_serve_ss(dev, model, codec, state, lm) -> dict:
    """The skip search (-ss) at full width on the LM route's lines, the
    char-512x6 LM (bf16, seeded). A seeded recognizer leaves every frame
    ambiguous, so each segment is one search step."""
    steps = []

    def on_batch(s, engine, logits):
        steps.append(segments_stepped(engine, logits))
        return contextlib.nullcontext()

    run = serve_lm_route(dev, model, codec, state, lm, "serve_ss", on_batch,
                         skip_search=True)
    counts, beam = run["counts"], run["engine"]._lm_beam
    check_skip_counts(counts, sum(steps), run["batches"], "serve_ss")
    emit({"phase": "serve_ss", "model": "hctr", "lm": "char-512x6",
          "compute_dtype": "bfloat16", "requests": LM_REQUESTS,
          "batch": BATCH, "width": LM_WIDTH,
          "lines_per_s": run["lines_per_s"],
          "peak_mem_mib": run["peak_mem_mib"], "segment_steps": sum(steps),
          "lm_batches": run["batches"], "ctx": beam._ctx,
          "group": beam.last_group, "seg_budget": beam._budget,
          "peek_rows": beam._peek, "launches": counts,
          "texts_equal_plain": not run["divergences"],
          "near_ties": len(run["divergences"]),
          "chars_per_line": statistics.mean(len(t) for t in run["texts"])})
    return counts


def plain_divergences(engine: ServingEngine, logits: torch.Tensor, texts,
                      what: str) -> list:
    """Decode ``logits`` again with K1-K4 swapped for their plain versions;
    for each group whose texts differ from ``texts``, the first divergence
    of the two searches (``first_divergence``), each emitted."""
    with torch.inference_mode(), plain_kernels():
        want = engine.decode_logits(logits)
    G, out = engine._lm_beam.last_group, []
    for s in range(0, len(texts), G):
        if texts[s:s + G] != want[s:s + G]:
            div = first_divergence(engine, logits[s:s + G])
            div["lines"] = [s + i for i, (a, b) in enumerate(
                zip(texts[s:s + G], want[s:s + G])) if a != b]
            out.append(div)
            emit({"phase": f"{what}_divergence", **div})
    return out


def near_prune_frames(logits: torch.Tensor, prune: float) -> int:
    """Frames with a class whose log-prob lies within ``K1_TOL`` of
    ``prune``: there K1 and its plain version could count it either way."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return int(((logp - prune).abs() <= K1_TOL).any(-1).sum())


def k1_exact(logits: torch.Tensor, prune: float, what: str,
             k: int = SEARCH_DEPTH) -> dict:
    """K1 against its plain version: top index and ``n_above`` exactly;
    vals and blank within ``K1_TOL`` of the value's size where it is past 1
    (a trained model's log-probs reach -100, where an f32 step is 8e-6)."""
    got = k1.topk_logsoftmax(logits, k=k, prune=prune)
    want = k1.topk_logsoftmax_plain(logits, k=k, prune=prune)
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]), f"{what}: K1 idx differs")
    check(torch.equal(got[3], want[3]), f"{what}: K1 n_above differs")
    pairs = ((got[0], want[0]), (got[2], want[2]))
    err = max((a - b).abs().max().item() for a, b in pairs)
    rel = max(((a - b).abs() / b.abs().clamp(min=1)).max().item()
              for a, b in pairs)
    check(rel <= K1_TOL, f"{what}: K1 vals/blank differ by {err} "
          f"({rel} of the value)")
    return {"max_abs_err": err, "max_err_of_value": rel,
            "largest_value": max(b.abs().max().item() for _, b in pairs),
            "frames": int(got[3].numel()),
            "frames_near_prune": near_prune_frames(logits, prune),
            "ambiguous_frames": int((got[3] != 1).sum())}


def phase_ss_peaky(dev, model, codec, state, lm):
    """Config #5: the skip search through ``ServingEngine.decode_logits`` on
    ``synth_peaky_logits(32, 1200, 7375)``, group 8, lp 0.8, lb 4.8, the
    seeded char-512x6 LM in bf16. Returns the main path's launches and the
    K2-K4 inputs of the skip route's new shapes."""
    engine = ServingEngine(model, state, codec, widths=(LM_WIDTH,),
                           decode_method="beam-search",
                           search_depth=SEARCH_DEPTH, lm=lm,
                           use_lm_pred=True, use_lm_score=True,
                           skip_search=True, lm_panelty=SS_LP,
                           len_bonus=SS_LB, lm_group=SS_GROUP, device=dev)
    t0 = time.perf_counter()
    logits = torch.from_numpy(synth_peaky_logits(
        PEAKY_B, PEAKY_T, codec.num_classes, seed=PEAKY_SEED)).to(dev)
    synth_s = time.perf_counter() - t0
    k1_check = k1_exact(logits, engine._prune_lp, "ss_peaky")
    _, ci, _, n_above = k1_outputs(engine, logits)
    unk = codec.unknown_id
    segs = blm.count_segments(ci, n_above, unknown_id=unk, run_max=RUN_MAX)
    kept = blm.count_kept_frames(ci, n_above, unknown_id=unk)
    with torch.inference_mode():
        engine.decode_logits(logits[:SS_GROUP])      # warm-up, one group
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()              # ---- main path: config #5
    t0 = time.perf_counter()
    with torch.inference_mode():
        texts = engine.decode_logits(logits)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()      # ---- end of main path
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    beam = engine._lm_beam
    steps = segments_stepped(engine, logits)
    check(len(texts) == PEAKY_B and all(texts), "ss_peaky: empty texts")
    check_skip_counts(counts, steps, 1, "ss_peaky")
    divergences = plain_divergences(engine, logits, texts, "ss_peaky")
    # the same search with the LM in f32: the kernels' f32 paths against
    # the plain versions, where a difference of 1e-5 is a near-tie
    engine32 = ServingEngine(model, state, codec, widths=(LM_WIDTH,),
                             decode_method="beam-search",
                             search_depth=SEARCH_DEPTH, lm=lm,
                             use_lm_pred=True, use_lm_score=True,
                             skip_search=True, lm_panelty=SS_LP,
                             len_bonus=SS_LB, lm_group=SS_GROUP, lm_f32=True,
                             device=dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        texts32 = engine32.decode_logits(logits)
    torch.cuda.synchronize()
    wall32_s = time.perf_counter() - t0
    div32 = plain_divergences(engine32, logits, texts32, "ss_peaky_f32")
    del engine32
    # one group again: unprofiled wall time, then the profiled decode
    # (device busy time; it also records K2-K4 at the skip route's shapes)
    group = logits[:SS_GROUP]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        engine.decode_logits(group)
    torch.cuda.synchronize()
    group_ms = (time.perf_counter() - t0) * 1e3
    group_steps = segments_stepped(engine, group)
    ladder = ((beam._ladder_k, beam._ladder_ctx) if beam._ladder_k
              else None)
    wanted = {
        # the run phase: one row of RUN_MAX positions a beam
        "peek_cache_attention@run": lambda a: a[0].shape[1] == RUN_MAX,
        "lse_rows@want_last": lambda a: a[0].shape[-2] == RUN_MAX - 1,
        "gather_write_kv": lambda a: True,
    }
    if ladder:
        # the first rung's cache, and the full depth after the climb (in
        # this group only if its segments reach the rung's end)
        wanted["peek_cache_attention@rung"] = (
            lambda a: a[1].shape[1] == beam._ladder_ctx
            and a[0].shape[1] != RUN_MAX)
        wanted["gather_write_kv@full_depth"] = (
            lambda a: a[0].shape[2] == beam._ctx)
    busy_ms, own, n_launch, top, recorded = profile_decode(
        engine, group, wanted, optional=("gather_write_kv@full_depth",))
    emit({"phase": "ss_peaky", "config": "bench.py #5", "model": "hctr",
          "lm": "char-512x6", "compute_dtype": "bfloat16",
          "lines": PEAKY_B, "frames": PEAKY_T, "classes": codec.num_classes,
          "seed": PEAKY_SEED, "lm_panelty": SS_LP, "len_bonus": SS_LB,
          "group": beam.last_group, "synth_s": synth_s,
          "lines_per_s": PEAKY_B / wall_s, "wall_ms": wall_s * 1e3,
          "segment_steps": steps, "wall_ms_per_segment_step":
              wall_s * 1e3 / steps,
          "segments_per_line": float(segs.mean()),
          "segments_max": int(segs.max()),
          "kept_frames_per_line": float(kept.mean()),
          "chars_per_line": statistics.mean(len(t) for t in texts),
          "ctx": beam._ctx, "seg_budget": beam._budget,
          "peek_rows": beam._peek, "ladder": ladder,
          "peak_mem_mib": peak_mib, "launches": counts,
          "k1_check": k1_check, "texts_equal_plain": not divergences,
          "divergences": divergences,
          "lines_differing_plain": sum(len(d["lines"]) for d in divergences),
          "f32_lines_per_s": PEAKY_B / wall32_s,
          "f32_texts_equal_plain": not div32, "f32_divergences": div32,
          "f32_lines_differing_bf16": sum(a != b for a, b in
                                          zip(texts, texts32)),
          "group0_wall_ms": group_ms, "group0_segment_steps": group_steps,
          "group0_device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "device_idle_share": (1 - busy_ms / group_ms if busy_ms > 0
                                else "not measured"),
          "group0_kernel_launches": n_launch, "own_kernels_ms": own,
          "top_kernels": top})
    # the bf16 decode may part from the plain one at a near-tie of bf16
    # rounding; the f32 decode only at a near-tie within 1e-5
    for div in divergences:
        check(div["diff"] < BF16_NEAR_TIE,
              f"ss_peaky: kernels and plain versions decode differently "
              f"beyond a bf16 near-tie: {div}")
    for div in div32:
        check(div["diff"] < NEAR_TIE, f"ss_peaky (f32): kernels and plain "
              f"versions decode differently beyond a near-tie: {div}")
    return counts, recorded


def phase_ss_kernels(dev, recorded: dict) -> dict:
    """K2, K3 and K4 on the inputs the skip route gave them at its new
    shapes (``recorded``, from ``phase_ss_peaky``): the run phase's K2 (8
    positions a beam) and K3 (the positions between the first and the last),
    and where the ladder engaged, K2 on a rung's cache and K4 at full depth
    after the climb; each against its plain version, then timed."""
    out = {}
    for key, args in sorted(recorded.items()):
        base = key.split("@")[0]
        if base == "peek_cache_attention":
            err = compare_k2(*args)
            q, k, _, lengths = args
            bms, by = k2_bound(q, k, lengths)
            fn, plain = k2.peek_cache_attention, k2.peek_cache_attention_plain
            shape = {"q": list(q.shape), "kv": list(k.shape)}
        elif base == "lse_rows":
            err = compare_k3(*args)
            x, emb = args
            rows, d = x.numel() // x.shape[-1], x.shape[-1]
            bms, by = bound_ms((rows + emb.shape[0]) * d * x.element_size()
                               + rows * 4, 2 * rows * emb.shape[0] * d,
                               BF16_OPS_PER_S)
            fn, plain = k3.lse_rows, k3.lse_rows_plain
            shape = {"x": list(x.shape), "emb": list(emb.shape)}
        else:
            err = compare_k4(*args)
            ck, _, idx, _, _, wpos = args
            n_lay, B, L = ck.shape[:3]
            row = ck[0, 0, 0].numel() * ck.element_size()
            bms, by = bound_ms(2 * n_lay * (int(torch.unique(idx).numel())
                                            * L + B * L) * row
                               + 2 * n_lay * int((wpos < L).sum()) * row
                               + 8 * B, 0, BF16_OPS_PER_S)
            fn, plain = k4.gather_write_kv, k4.gather_write_kv_plain
            shape = {"cache": list(ck.shape)}
        out[key] = {"max_abs_err": err, "shape": shape, "bound_ms": bms,
                    "bound_by": by, "ms": device_ms(lambda: fn(*args)),
                    "plain_ms": device_ms(lambda: plain(*args))}
    emit({"phase": "ss_kernels", **out})
    return out


def demo_hard_engines(dev, int8: bool = False, lm_dir: str = ""):
    """ServingEngines of the three routes over the committed demo/hard
    weights: hctr-tiny and the char LM (``lm_dir``, default the converted
    one), both in f32. ``int8``: the greedy and ``-ss`` routes with int8
    convs and the ``-ss`` LM's step in int8 (``--int8 --lm-int8``)."""
    chars_file = os.path.join(DEMO_HARD, "chars_list.txt")
    chars = load_chars_list(chars_file)
    state = torch.load(os.path.join(DEMO_ASSETS, "hctr_tiny.pt"),
                       weights_only=True)
    lm = TorchLMBackend(*load_lm(lm_dir or os.path.join(DEMO_ASSETS, "lm")))
    routes = {"greedy": dict(decode_method="greedy-search"),
              "beam": dict(decode_method="beam-search"),
              "ss": dict(decode_method="beam-search", lm=lm,
                         use_lm_pred=True, use_lm_score=True,
                         skip_search=True, lm_f32=True, lm_panelty=0.8,
                         len_bonus=0.0)}
    if int8:
        routes = {"greedy": dict(routes["greedy"], int8=True),
                  "ss": dict(routes["ss"], int8=True, lm_int8=True)}
    out = {}
    for name, kw in routes.items():
        model, _ = get_model_info("hctr-tiny", chars_list_file=chars_file)
        out[name] = ServingEngine(model, state, CTCCodec(chars),
                                  widths=WIDTHS, device=dev, **kw)
    return out


def cer(texts, labels) -> float:
    def dist(a, b):
        d = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            prev, d[0] = d[:], i
            for j, cb in enumerate(b, 1):
                d[j] = min(prev[j] + 1, d[j - 1] + 1, prev[j - 1] + (ca != cb))
        return d[-1]
    return (sum(dist(t, y) for t, y in zip(texts, labels))
            / sum(len(y) for y in labels))


def top2_gap(logits: torch.Tensor) -> float:
    """The smallest gap between a frame's two largest logits."""
    top2 = logits.float().topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def min_gap(engine: ServingEngine, logits: torch.Tensor, route: str) -> float:
    """How near a tie one line's decode came: greedy, the smallest gap
    between a frame's two largest logits; the LM search, the smallest gap
    between two adjacent live totals of a step's selection."""
    if route == "greedy":
        return top2_gap(logits)
    gaps = [float((tot[:, :-1] - tot[:, 1:])[tot[:, 1:] > -5e29].min())
            for _, tot, _, _ in selection_trace(engine, logits)
            if bool((tot[:, 1:] > -5e29).any())]
    return min(gaps) if gaps else float("inf")


def phase_demo_hard(dev):
    """The 150 test lines of demo/hard, served from the converted weights
    on the greedy, beam and skip-search (-ss, -lp 0.8 -lb 0.0, LM in f32)
    routes at batch 8: CER against the labels beside demo/hard/RESULTS.md's,
    and every line that differs from the JAX engine's committed texts.
    Greedy and -ss lines must equal them but for a reported near-tie."""
    with open(os.path.join(DEMO_ASSETS, "texts.json"), encoding="utf-8") as f:
        committed = json.load(f)
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    files = committed["files"]
    paths = [os.path.join(DEMO_HARD, "test", name) for name in files]
    truth = [labels[name] for name in files]
    engines = demo_hard_engines(dev)
    out, counts = {}, {}
    for route, engine in engines.items():
        engine.infer_files_batched(paths[:committed["batch"]],
                                   batch_size=committed["batch"])  # warm-up
        if route == "ss":
            reset_launches()      # ---- main path: the skip route
        texts, lps = engine.infer_files_batched(
            paths, batch_size=committed["batch"])
        if route == "ss":
            counts = launch_counts()  # ---- end of main path
        differ = [i for i, (a, b) in enumerate(zip(texts, committed[route]))
                  if a != b]
        lines = []
        for i in differ:
            _, x = engine.preprocess_bucketed(paths[i])
            with torch.inference_mode():
                logits = engine.model(
                    (torch.from_numpy(x).to(dev).float() - 127.5) / 127.5)
                gap = min_gap(engine, logits, route)
            lines.append({"file": files[i], "card": texts[i],
                          "jax": committed[route][i], "min_gap": gap})
            emit({"phase": "demo_hard_difference", "route": route,
                  **lines[-1]})
            check(route == "beam" or gap < NEAR_TIE,
                  f"demo_hard {route}: {files[i]} differs from the JAX text "
                  f"beyond a near-tie: {lines[-1]}")
        out[route] = {"cer": cer(texts, truth),
                      "cer_jax_texts": cer(committed[route], truth),
                      "lines_per_s": lps, "lines_differing": len(differ)}
    # K1 on the served logits: top index and n_above exactly as the plain
    # version's, at the -ss route's prune
    engine = engines["ss"]
    xs = np.concatenate([engine.preprocess_bucketed(p)[1] for p in paths])
    with torch.inference_mode():
        logits = torch.cat([engine.model(
            (torch.from_numpy(xs[s:s + 8]).to(dev).float() - 127.5) / 127.5)
            for s in range(0, len(xs), 8)])
    k1_check = k1_exact(logits, engine._prune_lp, "demo_hard")
    check(counts["topk_logsoftmax"] > 0 and counts["gather_write_kv"] > 0
          and counts["peek_cache_attention"] == LM_HARD_LAYERS
          * counts["lse_rows"], f"demo_hard -ss launches {counts}")
    emit({"phase": "demo_hard", "model": "hctr-tiny (trained, f32)",
          "lm": "char 128d/3L (trained, f32)", "lines": len(files),
          "batch": committed["batch"], "widths": list(WIDTHS),
          "results_md_cer": {"greedy": 0.0887, "ss": 0.0},
          "launches_ss": counts, "k1_check": k1_check, **out})
    return counts


def native_library() -> dict:
    """Where the native host decoder was loaded from, and proof that it was
    built from the port's source: the library's name carries the hash of
    the compiler flags and ``native/cbs_decoder.cc``."""
    import hashlib
    info = dict(_build.build_info["host:cbs_decoder"])
    src = _build.NATIVE / "cbs_decoder.cc"
    h = hashlib.sha256(" ".join(_build.HOST_FLAGS).encode())
    h.update(src.read_bytes())
    with open(info["path"], "rb") as f:
        info["sha256"] = hashlib.sha256(f.read()).hexdigest()
    info["source"] = str(src.relative_to(_build.NATIVE.parents[1]))
    check(info["path"] == str(_build._library_path(src, _build.HOST_FLAGS))
          and h.hexdigest()[:16] in os.path.basename(info["path"]),
          f"native decoder not built from {src}: {info}")
    return info


def phase_demo_hard_host(dev):
    """demo/hard's test lines on the host beam's three routes (f32, batch
    8): the forward and an f32 log-softmax on the card, the posteriors to
    the host once a batch, the search there (native, or Python with the
    char LM's proposals from ``LMScorer`` on the card). CER against the
    labels, lines/s, every line that differs from the JAX engine's texts
    with its smallest top-2 logit gap (beyond a near-tie it fails), and the
    n-gram route's time split. No kernel of K1-K4 may launch."""
    from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
        KenLMBackend)
    with open(os.path.join(DEMO_ASSETS, "texts.json"), encoding="utf-8") as f:
        committed = json.load(f)
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    files = committed["files"]
    paths = [os.path.join(DEMO_HARD, "test", name) for name in files]
    chars_file = os.path.join(DEMO_HARD, "chars_list.txt")
    chars = load_chars_list(chars_file)
    state = torch.load(os.path.join(DEMO_ASSETS, "hctr_tiny.pt"),
                       weights_only=True)
    lms = {"ngram": lambda: KenLMBackend(NGRAM_HARD),
           "tfm": lambda: TorchLMBackend(*load_lm(os.path.join(
               DEMO_ASSETS, "lm")), device=dev)}
    batch = committed["batch"]
    before = launch_counts()
    out = {}
    for route, kw in HOST_ROUTES.items():
        kw = dict(kw, lm_panelty=0.8, len_bonus=0.0)
        kw["lm"] = lms[kw["lm"]]() if "lm" in kw else None
        model, _ = get_model_info("hctr-tiny", chars_list_file=chars_file)
        engine = ServingEngine(model, state, CTCCodec(chars), widths=WIDTHS,
                               decode_method="beam-search", device=dev, **kw)
        native = type(engine._host_beam).__name__ == \
            "NativeBeamSearchDecoder"
        check(native == (route != "utp"), f"{route}: decoder "
              f"{type(engine._host_beam).__name__}")
        n = UTP_LINES if route == "utp" else len(files)
        engine.infer_files_batched(paths[:batch], batch_size=batch)  # warm
        texts, lps = engine.infer_files_batched(paths[:n], batch_size=batch)
        differ = []
        for i in (i for i in range(n) if texts[i] != committed[route][i]):
            _, x = engine.preprocess_bucketed(paths[i])
            with torch.inference_mode():
                gap = top2_gap(engine.model(
                    (torch.from_numpy(x).to(dev).float() - 127.5) / 127.5))
            differ.append({"file": files[i], "card": texts[i],
                           "jax": committed[route][i], "min_gap": gap})
            emit({"phase": "demo_hard_host_difference", "route": route,
                  **differ[-1]})
            check(gap < NEAR_TIE, f"demo_hard_host {route}: {files[i]} "
                  f"differs from the JAX text beyond a near-tie: "
                  f"{differ[-1]}")
        truth = [labels[name] for name in files[:n]]
        out[route] = {"command": committed["host_routes"][route],
                      "decoder": type(engine._host_beam).__name__,
                      "lines": n, "cer": cer(texts, truth),
                      "cer_jax_texts": cer(committed[route][:n], truth),
                      "lines_per_s": lps, "lines_differing": len(differ)}
        if route == "ngram_ss":
            out[route]["split"] = host_split(engine, paths, batch)
    check(launch_counts() == before, "a K1-K4 kernel launched on the host "
          "beam's routes")
    emit({"phase": "demo_hard_host", "model": "hctr-tiny (trained, f32)",
          "lm": "n-gram demo/hard/lm/ngram.hblm; char 128d/3L (trained, "
          "f32)", "batch": batch, "widths": list(WIDTHS),
          "utp_lines": f"the first {UTP_LINES} of {len(files)}: LM "
          "proposals alone ask the LM once a searched frame, about 1 line/s",
          "results_md_cer": {"ngram_ss": 0.0015},
          "native_library": native_library(), **out})
    return out


def host_split(engine: ServingEngine, paths, batch: int) -> dict:
    """The n-gram route's time split over all lines, batch by batch: the
    forward + log-softmax (CUDA events), the D2H of the posteriors and the
    host search (host clock), each in ms a line."""
    fwd, d2h, search = [], [], []
    for s in range(0, len(paths), batch):
        x = np.concatenate([engine.preprocess_bucketed(p)[1]
                            for p in paths[s:s + batch]])
        with torch.inference_mode():
            xs = torch.from_numpy(x).to(engine.device)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            logp = torch.log_softmax(
                engine.model((xs.float() - 127.5) / 127.5).float(), dim=-1)
            e1.record()
            e1.synchronize()
            fwd.append(e0.elapsed_time(e1))
            t0 = time.perf_counter()
            host = logp.cpu().numpy()
            t1 = time.perf_counter()
            engine._host_beam.decode(host.transpose(1, 0, 2),
                                     already_log=True)
            t2 = time.perf_counter()
        d2h.append((t1 - t0) * 1e3)
        search.append((t2 - t1) * 1e3)
    n = len(paths)
    return {"forward_logsoftmax_ms_a_line": sum(fwd) / n,
            "d2h_ms_a_line": sum(d2h) / n,
            "host_search_ms_a_line": sum(search) / n,
            "posterior_bytes_a_batch": int(host.nbytes)}


def eval_near_ties(dev, indices, batch: int) -> dict:
    """How near a tie each eval line (by its index in the test split) came
    on the card: its eval batch (the loader keeps the split's order,
    ``batch`` lines a batch) through the recognizer in f32 and in bf16; the
    smallest top-2 logit gap of each, and the largest |bf16 - f32| logit of
    the line, and the frames whose argmax bf16 moved. A line whose f32 gap
    is below twice that deviation is a bf16 near-tie: there a bf16
    forward's argmax may go either way."""
    from handwritten_chinese_ocr_samples_torch.data.bucketing import (
        AlignCollate, BucketSpec)
    from handwritten_chinese_ocr_samples_torch.data.dataset import (
        ImageDataset)
    state = torch.load(os.path.join(DEMO_ASSETS, "hctr_tiny.pt"),
                       weights_only=True)
    models = []
    for dt in (torch.float32, torch.bfloat16):
        model, _ = get_model_info("hctr-tiny", data_dir=DEMO_HARD, dtype=dt)
        model.load_state_dict(state)
        models.append(model.to(dev).eval())
    h = models[0].img_height
    ds = ImageDataset(DEMO_HARD, (1, h), "test", batch_size=batch)
    collate = AlignCollate(imgH=h, PAD=models[0].pad_mode,
                           bucket_spec=BucketSpec())
    out = {}
    for i in indices:
        first = i // batch * batch
        x = torch.from_numpy(collate([ds[j] for j in range(
            first, first + batch)])["images"]).to(dev)
        with torch.inference_mode():
            f32, bf16 = (m(x)[i - first].float() for m in models)
        out[i] = {"gap_f32": top2_gap(f32), "gap_bf16": top2_gap(bf16),
                  "bf16_dev": (bf16 - f32).abs().max().item(),
                  "frames_argmax_moved": int(
                      (f32.argmax(-1) != bf16.argmax(-1)).sum())}
    return out


def phase_eval_demo_hard(dev) -> dict:
    """The port's eval CLI, as a user runs it (``cli/test.py`` through its
    ``main(argv)``), on demo/hard's test split with RESULTS.md's three
    commands, the recognizer in bf16: each CER beside RESULTS.md's (within
    ``EVAL_CER_TOL``) and beside the JAX eval's at the same command (the
    committed texts), every line that differs from those texts with its
    top-2 gaps on the card (beyond a bf16 near-tie it fails), K1-K4
    launched on the LM command, and each of them held against its plain
    version on the first inputs that command gave it (K2's first with a
    cache ``EVAL_K2_DEPTH`` deep); then the int8 commands
    (``eval_int8_commands``). Returns the LM command's launches and I1's on
    each int8 command."""
    import io
    from handwritten_chinese_ocr_samples_torch.cli import test as eval_cli
    with open(os.path.join(DEMO_ASSETS, "texts.json"), encoding="utf-8") as f:
        committed = json.load(f)["eval"]
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    files = committed["files"]
    truth = [labels[name] for name in files]
    batch = committed["batch"]
    out, counts = {}, {}
    for name, (flags, results_md) in EVAL_COMMANDS.items():
        argv = ["-m", "hctr-tiny", "-f", f"{DEMO_ASSETS}/hctr_tiny.pt",
                "-i", DEMO_HARD, "-bm", "-b", str(batch), "-tv",
                "-d", str(dev), *flags]
        buf = io.StringIO()
        # the LM command keeps the first inputs of each kernel it launches,
        # K2's first with a cache EVAL_K2_DEPTH deep or more
        wanted = ({k: (lambda a: True) for k in launch_counts()}
                  | {"peek_cache_attention": lambda a: bool(
                      (a[3] >= EVAL_K2_DEPTH).any())}
                  if name == "lm_ss" else {})
        reset_launches()          # ---- main path: the eval CLI
        t0 = time.perf_counter()
        with record_first(wanted) as kept, contextlib.redirect_stdout(buf):
            result = eval_cli.main(argv)
        wall = time.perf_counter() - t0
        launched = launch_counts()  # ---- end of main path
        text = buf.getvalue()
        texts = [ln[5:] for ln in text.splitlines() if ln.startswith("PRE: ")]
        printed = [float(ln.split(":", 1)[1]) for ln in text.splitlines()
                   if ln.startswith("Total Test CER:")]
        rate = [ln for ln in text.splitlines() if ln.startswith("lines: ")]
        check(len(texts) == len(files) and printed == [result],
              f"eval {name}: {len(texts)} texts, CER lines {printed}")
        jax_texts = committed[name]["texts"]
        differ = [i for i in range(len(files)) if texts[i] != jax_texts[i]]
        gaps = eval_near_ties(dev, differ, batch)
        for i in differ:
            line = {"file": files[i], "card": texts[i], "jax": jax_texts[i],
                    **gaps[i]}
            emit({"phase": "eval_demo_hard_difference", "command": name,
                  **line})
            check(line["gap_f32"] < 2 * line["bf16_dev"],
                  f"eval {name}: {files[i]} differs from the JAX eval text "
                  f"beyond a bf16 near-tie: {line}")
        jax_cer = committed[name]["cer"]
        out[name] = {"argv": " ".join(argv[:-len(flags)] + flags),
                     "cer": result, "cer_check": cer(texts, truth),
                     "gate": {"results_md_cer": results_md,
                              "abs_diff": abs(result - results_md),
                              "tolerance": EVAL_CER_TOL,
                              "jax_eval_cer_same_command": jax_cer,
                              "abs_diff_jax_eval": abs(result - jax_cer)},
                     "lines_differing": len(differ),
                     "rate": rate[-1], "wall_s_with_load": wall,
                     "launches": launched}
        check(abs(result - results_md) <= EVAL_CER_TOL,
              f"eval {name}: CER {result} vs RESULTS.md {results_md} "
              f"(the JAX eval at the same command: {jax_cer})")
        if name == "lm_ss":
            counts = launched
            x, kw = kept["topk_logsoftmax"]
            out[name]["kernel_checks"] = {
                "topk_logsoftmax": k1_exact(x, kw["prune"], "eval lm_ss",
                                            k=kw["k"]),
                "peek_cache_attention": {
                    "max_abs_err": compare_k2(*kept["peek_cache_attention"]),
                    "q": list(kept["peek_cache_attention"][0].shape),
                    "kv": list(kept["peek_cache_attention"][1].shape),
                    "cache_len_max": int(
                        kept["peek_cache_attention"][3].max()),
                    "dtype": str(kept["peek_cache_attention"][0].dtype)},
                "lse_rows": {
                    "max_abs_err": compare_k3(*kept["lse_rows"]),
                    "x": list(kept["lse_rows"][0].shape),
                    "emb": list(kept["lse_rows"][1].shape),
                    "dtype": str(kept["lse_rows"][0].dtype)},
                "gather_write_kv": {
                    "max_abs_err": compare_k4(*kept["gather_write_kv"]),
                    "cache": list(kept["gather_write_kv"][0].shape),
                    "dtype": str(kept["gather_write_kv"][0].dtype)}}
            out[name]["kernel_checks"]["topk_logsoftmax"].update(
                logits=list(x.shape), dtype=str(x.dtype))
    check(all(counts[k] > 0 for k in counts), f"eval -ss launches {counts}")
    int8 = eval_int8_commands(dev, files, truth, batch)
    emit({"phase": "eval_demo_hard", "lines": len(files),
          "recognizer": "hctr-tiny (trained, bf16)",
          "cer_tolerance": EVAL_CER_TOL, **out, **int8})
    return counts, {k: v["i1_launches"] for k, v in int8.items()}


# ------------------------------------------------------------ int8 (I1)
def conv_site_shapes(model, x) -> list:
    """Each conv site of one forward of ``model`` on ``x``, in order:
    ``(name, (B, Cin, H, W), Cout, k)``."""
    out, hooks = [], []
    for name, m in quant.conv_sites(model).items():
        hooks.append(m.register_forward_pre_hook(
            lambda m, a, name=name: out.append(
                (name, tuple(a[0].shape), m.out_channels,
                 m.kernel_size[0]))))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return out


def i1_ops(shape, cout: int, k: int) -> float:
    B, cin, H, W = shape
    return 2.0 * B * H * W * cout * cin * k * k


def i1_bound(shape, cout: int, k: int, out_bytes: int = 2):
    """(bound ms, bound by) of I1's conv: s8 activation in, s8 weights,
    compute-dtype output out once; the int8 operations at the int8 peak."""
    B, cin, H, W = shape
    moved = B * H * W * cin + cout * cin * k * k + B * H * W * cout * out_bytes
    return bound_ms(moved, i1_ops(shape, cout, k), INT8_OPS_PER_S)


def i1_site(dev, g, shape, cout: int, k: int, dtype=torch.bfloat16,
            amax_share: float = INT8_AMAX_SHARE, bias: bool = True):
    """A seeded activation of ``shape`` and the int8 state of a conv site
    (``ops/int8_conv.QuantConv``) at an absmax of ``amax_share`` of its
    largest value, so that some values clip."""
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    w = torch.randn((cout, shape[1], k, k), device=dev, generator=g) / (
        shape[1] * k * k) ** 0.5
    b = torch.randn((cout,), device=dev, generator=g) if bias else None
    return x, ic.QuantConv(w, b, float(x.abs().max()) * amax_share)


def compare_i1(x, site) -> tuple:
    """I1 (quantize, then conv) against its plain versions on the same card
    tensors: both bit for bit, the conv on the kernel its shape takes (the
    route's launch count moves by one) and, where that is ``wgmma``, on the
    ``mma.sync`` kernel too. Returns the largest |difference| of the conv
    and of the quantize (0 each) and the route."""
    q, qp = ic.quantize(x, site.s_x), ic.quantize_plain(x, site.s_x)
    args = (site.w_q, site.alpha, site.scale, site.bias, site.kh, site.kw,
            x.dtype)
    route = ic.conv_route(q.shape, site.kh, site.kw)
    before = dict(ic.launches_by_route)
    y = ic.conv_int8(q, *args)
    check(ic.launches_by_route[route] == before[route] + 1,
          f"I1 conv at {tuple(q.shape)}: not one {route} launch")
    yp = ic.conv_int8_plain(qp, *args)
    outs = [y] + ([ic.conv_int8_cuda(q, *args, route="mma")]
                  if route == "wgmma" else [])
    torch.cuda.synchronize()
    what = (tuple(x.shape), site.w_q.shape[0], site.kh, str(x.dtype), route)
    check(torch.equal(q, qp), f"I1 quantize differs at {what}")
    q_err = (q.int() - qp.int()).abs().max().item()
    err = 0.0
    for got, kernel in zip(outs, (route, "mma")):
        err = max(err, (got.float() - yp.float()).abs().max().item())
        check(torch.equal(got, yp), f"I1 conv ({kernel}) differs at {what}: "
              f"{err}")
    return err, q_err, route


def compare_i1_gemm(dev, g, M: int, K: int, N: int) -> float:
    """I1 as the LM's GEMM (``linear_int8``: dynamic ``s_x``, ``alpha =
    s_x``, ``scale = s_w``) against its plain versions, bit for bit."""
    x = torch.randn((M, K), device=dev, generator=g).to(torch.bfloat16)
    w_q, s_w = ic.quantize_weight(
        torch.randn((N, K), device=dev, generator=g), (1,))
    w_q, s_w = ic.pack_weight(w_q), s_w.reshape(-1)
    b = torch.randn((N,), device=dev, generator=g)
    y = ic.linear_int8(x, w_q, s_w, b, torch.bfloat16)
    s_x = ic.scale_of(x.abs().amax()).reshape(1)
    yp = ic.conv_int8_plain(ic.quantize_plain(x, s_x), w_q, s_x, s_w, b, 1,
                            1, torch.bfloat16)
    torch.cuda.synchronize()
    check(torch.equal(y, yp), f"I1 GEMM differs at {(M, K, N)}")
    return (y.float() - yp.float()).abs().max().item()


def i1_library(q: torch.Tensor, site):
    """The library route to the same function: im2col of the s8 activation
    in bf16 (exact for |q| <= 127), cast to s8, ``torch._int_mm`` (K and N
    padded to multiples of 8), the same dequantisation. Timed only."""
    B, H, W, cin = q.shape
    N = site.w_q.shape[0]
    k = site.kh
    K = cin * k * k
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
    # (N, kh, kw, Cin) -> (N, Cin * kh * kw), F.unfold's order
    wmat = site.w_q[:, :K].reshape(N, k, k, cin).permute(0, 3, 1, 2)
    wpad = torch.zeros((Kp, Np), dtype=torch.int8, device=q.device)
    wpad[:K, :N] = wmat.reshape(N, K).T
    scale = site.scale[None, :]
    bias = None if site.bias is None else site.bias[None, :]

    def run():
        cols = torch.nn.functional.unfold(
            q.permute(0, 3, 1, 2).to(torch.bfloat16), k, padding=k // 2)
        a = torch.zeros((B * H * W, Kp), dtype=torch.int8, device=q.device)
        a[:, :K] = cols.transpose(1, 2).reshape(B * H * W, K).to(torch.int8)
        acc = torch._int_mm(a, wpad)[:, :N]
        y = acc.float() * site.alpha * scale
        if bias is not None:
            y = y + bias
        return y.to(torch.bfloat16).view(B, H, W, N).permute(0, 3, 1, 2)
    return run


def quantize_bound(shape, dtype=torch.bfloat16):
    """(bound ms, bound by) of I1's quantize: the compute-dtype activation
    read once and one s8 byte an element written; it does no product."""
    n = float(np.prod(shape))
    return bound_ms(n * (torch.finfo(dtype).bits // 8 + 1), 0.0,
                    INT8_OPS_PER_S)


def i1_site_time(x, site, count: int) -> dict:
    """I1 on ``i1_site``'s activation and site (``count`` sites of its shape
    run a forward), timed by ``device_ms``: the conv on the kernel its shape
    takes beside its bound, and the quantize beside its bytes bound."""
    shape, cout, k = tuple(x.shape), site.w_q.shape[0], site.kh
    q = ic.quantize(x, site.s_x)
    args = (q, site.w_q, site.alpha, site.scale, site.bias, k, k,
            torch.bfloat16)
    bms, by = i1_bound(shape, cout, k)
    qbms, qby = quantize_bound(shape)
    out = {"shape": list(shape), "cout": cout, "k": k, "sites": count,
           "route": ic.conv_route(q.shape, k, k),
           "ms": device_ms(lambda: ic.conv_int8(*args)),
           "bound_ms": bms, "bound_by": by,
           "quantize_ms": device_ms(lambda: ic.quantize(x, site.s_x)),
           "quantize_bound_ms": qbms, "quantize_bound_by": qby}
    out["share_of_bound"] = bms / out["ms"]
    out["quantize_share_of_bound"] = qbms / out["quantize_ms"]
    return out


def i1_time(dev, g, shape, cout: int, k: int, count: int) -> dict:
    """``i1_site_time``, and beside it the conv on the ``mma.sync`` kernel,
    its plain version, the library route (im2col + ``_int_mm``) and the
    bf16 cuDNN convolution of the same site (the float route's own), and
    the quantize's plain version."""
    x, site = i1_site(dev, g, shape, cout, k)
    out = i1_site_time(x, site, count)
    q = ic.quantize(x, site.s_x)
    args = (q, site.w_q, site.alpha, site.scale, site.bias, k, k,
            torch.bfloat16)
    lib = i1_library(q, site)
    wb = torch.randn((cout, shape[1], k, k), device=dev,
                     generator=g).to(torch.bfloat16)
    out.update(
        mma_ms=device_ms(lambda: ic.conv_int8_cuda(*args, route="mma")),
        plain_ms=device_ms(lambda: ic.conv_int8_plain(*args)),
        library_ms=device_ms(lib),
        bf16_conv_ms=device_ms(lambda: torch.nn.functional.conv2d(
            x, wb, padding=k // 2)),
        quantize_plain_ms=device_ms(lambda: ic.quantize_plain(x, site.s_x)))
    out["library_equal"] = bool(torch.equal(lib(), ic.conv_int8(*args)))
    ops = i1_ops(shape, cout, k)
    out["tops"] = ops / out["ms"] / 1e9
    out["mma_tops"] = ops / out["mma_ms"] / 1e9
    return out


def i1_host_us(dev, calls: int = 2000) -> dict:
    """Host µs a call of I1's wrappers (quantize, conv, one ``QuantConv``
    site) and of a PyTorch add, in a loop at a tiny shape, where the card
    waits for the host."""
    g = torch.Generator(device=dev).manual_seed(9)
    x, site = i1_site(dev, g, (1, 64, 4, 16), 64, 3)
    q = ic.quantize(x, site.s_x)
    args = (q, site.w_q, site.alpha, site.scale, site.bias, 3, 3,
            torch.bfloat16)

    def per_call(fn) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6
    with torch.inference_mode():
        return {"quantize": per_call(lambda: ic.quantize(x, site.s_x)),
                "conv_int8": per_call(lambda: ic.conv_int8(*args)),
                "site": per_call(lambda: site(x)),
                "torch_add": per_call(lambda: x + x)}


def int8_site_shapes(dev) -> tuple:
    """The distinct conv site shapes of a full-width ``hctr`` forward at
    b4 w1600 and of a ``hctr-tiny`` one at b4 w512 (from hooks on seeded
    float forwards): ``{(shape, cout, k): count}`` each."""
    out = []
    for tag, width in (("hctr", WIDTHS[-1]), ("hctr-tiny", WIDTHS[0])):
        model, _ = get_model_info(tag, chars_list_file=CHARS_LIST,
                                  dtype=torch.bfloat16)
        model.load_state_dict(seeded_state_dict(model, 0))
        model.to(dev).eval()
        x = torch.zeros((BATCH, 128, width, 1), device=dev)
        counts = {}
        for _, shape, cout, k in conv_site_shapes(model, x):
            counts[(shape, cout, k)] = counts.get((shape, cout, k), 0) + 1
        out.append(counts)
        del model
    return tuple(out)


def phase_int8_kernels(dev) -> dict:
    """I1 timed at every distinct site shape of the full-width forward, in
    full (both conv kernels, plain, library, cuDNN) at the five that weigh
    most (operations times sites), and the host's cost of a call; then held
    against its plain version bit for bit (quantize and conv, on the
    ``wgmma`` and the ``mma.sync`` kernel where the shape takes ``wgmma``)
    at every distinct site shape of full ``hctr`` (b4 w1600) and
    ``hctr-tiny`` (b4 w512), at the LM's GEMM shapes, and on edge cases.
    Returns the timings (``timed`` heaviest first) and the largest error."""
    full, tiny = int8_site_shapes(dev)
    check(sum(full.values()) == HCTR_SITES
          and sum(tiny.values()) == TINY_SITES,
          f"conv sites: {sum(full.values())} and {sum(tiny.values())}")
    for sites, want in ((full, HCTR_WGMMA), (tiny, TINY_WGMMA)):
        on_wgmma = sum(n for (shape, _, k), n in sites.items()
                       if ic.conv_route((shape[0], *shape[2:], shape[1]), k,
                                        k) == "wgmma")
        check(on_wgmma == want, f"{on_wgmma} sites on the wgmma route, "
              f"not {want}")
    g = torch.Generator(device=dev).manual_seed(8)
    heavy = sorted(full, key=lambda s: -i1_ops(*s) * full[s])[:INT8_TIMED]
    times = [i1_time(dev, g, *s, full[s]) for s in heavy]
    by_site = [i1_site_time(*i1_site(dev, g, *s), full[s])
               for s in sorted(full, key=lambda s: -i1_ops(*s))]
    errs, q_errs, checked = [], [], []
    for shape, cout, k in list(full) + list(tiny):
        err, q_err, route = compare_i1(*i1_site(dev, g, shape, cout, k))
        errs.append(err)
        q_errs.append(q_err)
        checked.append([*shape, cout, k, route])
    for M in (LM_BEAMS, 8 * LM_BEAMS):
        for K, N in ((512, 2048), (2048, 512), (512, LM_VOCAB)):
            errs.append(compare_i1_gemm(dev, g, M, K, N))
            checked.append([M, K, N, "mma"])
    edges = [((1, 64, 3, 5), 64, 3, {}),             # W < 128: one tile
             ((3, 8, 7, 37), 40, 3, {}),              # W off the tile, Cin 8
             ((2, 48, 5, 129), 72, 1, {}),            # 1x1, N off the tile
             ((2, 64, 4, 50), 64, 3, {"amax_share": 0.0}),   # amax 0
             ((2, 1, 16, 33), 64, 3, {"dtype": torch.float32}),
             ((2, 32, 6, 19), 64, 3, {"bias": False}),
             ((2, 128, 3, 200), 128, 3, {}),          # W not a multiple of 128
             ((2, 64, 1, 300), 64, 3, {}),            # H = 1, Cout 64
             ((2, 64, 4, 130), 128, 1, {}),           # 1x1 with Cin 64
             ((2, 128, 5, 140), 256, 3, {"dtype": torch.float32}),  # f32 out
             ((2, 64, 3, 37), 72, 3, {}),             # W * 2 bytes off 16
             ((2, 256, 4, 129), 320, 3, {"bias": False})]   # N tail tile
    for shape, cout, k, kw in edges:
        err, q_err, route = compare_i1(*i1_site(dev, g, shape, cout, k,
                                                **kw))
        errs.append(err)
        q_errs.append(q_err)
        checked.append([*shape, cout, k, route])
    out = {"timed": times, "by_site": by_site, "host_us": i1_host_us(dev),
           "checked": checked, "max_abs_err": max(errs),
           "quantize_max_abs_err": max(q_errs),
           "sites": {"hctr": HCTR_SITES, "hctr-tiny": TINY_SITES},
           "sites_on_wgmma": {"hctr": HCTR_WGMMA, "hctr-tiny": TINY_WGMMA}}
    emit({"phase": "int8_kernels", **out})
    return out


def int8_engine(model_tag: str, state, codec, dev, **kw) -> ServingEngine:
    """A fresh model (the int8 state goes onto its sites) in an engine."""
    model, _ = get_model_info(model_tag, chars_list_file=CHARS_LIST,
                              dtype=torch.bfloat16)
    return ServingEngine(model, state, codec, widths=WIDTHS, device=dev,
                         **kw)


def reset_i1() -> None:
    ic.quantize_launches = 0
    ic.launches_by_route.update(wgmma=0, mma=0)


def i1_counts() -> dict:
    return {"conv": sum(ic.launches_by_route.values()),
            "quantize": ic.quantize_launches,
            **ic.launches_by_route}


def i1_per(sites: int, wgmma: int, n: int = 1) -> dict:
    """I1's launches in ``n`` forwards of a model with ``sites`` conv sites,
    ``wgmma`` of them on that route."""
    return {"conv": sites * n, "quantize": sites * n, "wgmma": wgmma * n,
            "mma": (sites - wgmma) * n}


# a forward's kernels by the name the profiler gives them, in this order
FORWARD_GROUPS = (("i1_conv_wgmma", "conv_wgmma_kernel"),
                  ("i1_conv_mma", "conv_s8_kernel"),
                  ("i1_quantize", "quantize_"),
                  ("cudnn_conv", "fprop"), ("elementwise", "elementwise"))


def forward_breakdown(model, x) -> dict:
    """One forward under torch.profiler: device busy ms, kernel launches and
    device ms by ``FORWARD_GROUPS`` (the rest as ``other``)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    groups = {name: 0.0 for name, _ in FORWARD_GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in kernels:
        name = next((n for n, tag in FORWARD_GROUPS if tag in key), "other")
        groups[name] += ms
    return {"device_ms": sum(ms for _, ms, _ in kernels),
            "launches": sum(n for _, _, n in kernels), "by_group_ms": groups}


def phase_serve_int8(dev, codec, state) -> dict:
    """The seeded full-width ``hctr`` served greedy through
    ``ServingDaemon`` with ``int8=True`` on the 16 lines of ``serve``
    (calibrated on the first batch), beside the bf16 engine in the same
    call: lines/s, the forward's ms at each bucket width and its device
    time by kernel group (``forward_breakdown``), peak memory, the 33
    sites and I1's launches a forward by route, and the int8 logits within
    ``INT8_LOGIT_TOL`` of the bf16 logits' scale."""
    images = text_lines(N_REQUESTS, seed=0)
    engines = {"bf16": int8_engine("hctr", state, codec, dev),
               "int8": int8_engine("hctr", state, codec, dev, int8=True)}

    def serve(engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ServingDaemon(engine, batch_size=BATCH,
                           max_delay_ms=500.0) as daemon:
            futs = [daemon.submit_array(a) for a in images]
        texts = [f.result() for f in futs]
        return texts, N_REQUESTS / (time.perf_counter() - t0)

    out = {}
    for name, engine in engines.items():
        torch.cuda.reset_peak_memory_stats(dev)
        if name == "int8":
            reset_i1()        # ---- main path: int8 greedy serving
        texts, lps_first = serve(engine)
        texts_again, lps = serve(engine)
        if name == "int8":
            counts = i1_counts()  # ---- end of main path
        out[name] = {"lines_per_s_first_daemon": lps_first,
                     "lines_per_s": lps,
                     "peak_mem_mib": torch.cuda.max_memory_allocated(dev)
                     / 2 ** 20}
        check(texts == texts_again and len(texts) == N_REQUESTS
              and all(isinstance(t, str) for t in texts),
              f"serve_int8 {name}: texts malformed or unsteady")
        out[name]["texts"] = texts
    q = engines["int8"]
    check(q._quant is not None and len(q._quant) == HCTR_SITES,
          f"serve_int8: {len(q._quant or {})} calibrated sites")
    # each daemon run flushes FIFO batches of BATCH a bucket (as in serve):
    # one forward, HCTR_SITES launches of each entry point, a batch
    items = [q.preprocess_array(a) for a in images]
    buckets = [bw for bw, _ in items]
    batches = 2 * sum(-(-buckets.count(bw) // BATCH) for bw in set(buckets))
    check(counts == i1_per(HCTR_SITES, HCTR_WGMMA, batches),
          f"serve_int8: I1 launches {counts} for {batches} batches")
    w = WIDTHS[-1]
    rows = [x for bw, x in items if bw == w] or [items[0][1]]
    u8 = torch.from_numpy(np.concatenate((rows * BATCH)[:BATCH]))
    fwd, per_forward = {"bf16": {}, "int8": {}}, None
    breakdown = {"bf16": {}, "int8": {}}
    with torch.inference_mode():
        for bw in WIDTHS:
            xw = (u8[:, :, :bw].to(dev).float() - 127.5) / 127.5
            for name, engine in engines.items():
                fwd[name][str(bw)] = cuda_ms(lambda: engine.model(xw))
                breakdown[name][str(bw)] = forward_breakdown(engine.model, xw)
        x = (u8.to(dev).float() - 127.5) / 127.5
        reset_i1()
        lq = q.model(x)
        per_forward = i1_counts()
        lf = engines["bf16"].model(x)
    check(per_forward == i1_per(HCTR_SITES, HCTR_WGMMA),
          f"serve_int8: I1 launches a forward {per_forward}")
    check(bool(torch.isfinite(lq).all()) and lq.shape == lf.shape,
          "serve_int8: int8 logits not finite or misshapen")
    rel = ((lq - lf).abs().max() / lf.abs().max()).item()
    check(rel < INT8_LOGIT_TOL, f"serve_int8: int8 logits differ from bf16 "
          f"by {rel} of their scale")
    differ = sum(a != b for a, b in zip(out["int8"].pop("texts"),
                                        out["bf16"].pop("texts")))
    res = {"model": "hctr", "classes": codec.num_classes, "batch": BATCH,
           "requests": N_REQUESTS, "widths": list(WIDTHS),
           "sites": len(q._quant), "batches_served": batches,
           "i1_launches_per_forward": per_forward,
           "i1_launches_serving": counts, "forward_ms_by_width": fwd,
           "forward_device_by_width": breakdown,
           "int8_vs_bf16_logits_of_scale": rel,
           "lines_differing_from_bf16": differ, **out}
    emit({"phase": "serve_int8", **res})
    return counts


def int8_near_tie(engine, logits_q, logits_f, route: str) -> dict:
    """How near a tie one int8 line came: the smallest top-2 gap (greedy:
    of its int8 logits; the LM search: of its step totals), beside the
    line's int8 quant noise (max |int8 - f32| logit). ``tests/
    test_torch_int8.py`` bounds the port's distance from JAX int8 by a
    tenth of that noise, so a gap below twice that bound is a near-tie."""
    noise = (logits_q - logits_f).abs().max().item()
    gap = min_gap(engine, logits_q, route)
    return {"min_gap": gap, "quant_noise": noise,
            "near_tie": gap < 2 * INT8_JAX_SHARE * noise}


def phase_demo_hard_int8(dev) -> dict:
    """The 150 test lines of demo/hard in f32, batch 8, int8 recognizer on
    the greedy route and the skip search with the int8 LM (``-ss --lm-int8
    --lm-f32``, lp 0.8, lb 0.0). On JAX's calibration (``int8.json``) the
    texts equal the JAX int8 engine's but for reported near-ties; on the
    port's own first-batch calibration the CER is within
    ``INT8_CER_TOL`` of the float route's and at most
    ``INT8_LINES_DIFFER`` lines differ from it (the JAX engine's f32
    texts, ``texts.json``)."""
    with open(os.path.join(DEMO_ASSETS, "int8.json"), encoding="utf-8") as f:
        ref = json.load(f)
    with open(os.path.join(DEMO_ASSETS, "texts.json"), encoding="utf-8") as f:
        floats = json.load(f)
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    files = ref["files"]
    paths = [os.path.join(DEMO_HARD, "test", name) for name in files]
    truth = [labels[name] for name in files]
    jax_amax = quant_flax_to_torch(ref["calibration"])
    out, counts = {}, {}
    for calib in ("jax", "port"):
        for route, engine in demo_hard_engines(dev, int8=True).items():
            if calib == "jax":
                engine._quant = jax_amax
                quant.set_conv_amax(engine.model, jax_amax)
            reset_i1()        # ---- main path: int8 demo/hard
            texts, lps = engine.infer_files_batched(
                paths, batch_size=ref["batch"])
            counts[f"{route}_{calib}_calibration"] = i1_counts()
            key = f"{route}_{calib}_calibration"
            res = {"cer": cer(texts, truth), "lines_per_s": lps,
                   "cer_float_route": cer(floats[route], truth),
                   "lines_differing_from_float": sum(
                       a != b for a, b in zip(texts, floats[route]))}
            if calib == "jax":
                differ = [i for i, (a, b) in enumerate(zip(texts, ref[route]))
                          if a != b]
                res["cer_jax_int8"] = cer(ref[route], truth)
                res["lines_differing_from_jax_int8"] = len(differ)
                for i in differ:
                    _, x = engine.preprocess_bucketed(paths[i])
                    x = (torch.from_numpy(x).to(dev).float() - 127.5) / 127.5
                    with torch.inference_mode():
                        lq = engine.model(x)
                        quant.set_conv_amax(engine.model, None)
                        lf = engine.model(x)
                        quant.set_conv_amax(engine.model, jax_amax)
                        tie = int8_near_tie(engine, lq, lf, route)
                    line = {"route": route, "file": files[i],
                            "card": texts[i], "jax": ref[route][i], **tie}
                    emit({"phase": "demo_hard_int8_difference", **line})
                    check(tie["near_tie"], f"demo_hard_int8 {route}: "
                          f"{files[i]} differs from the JAX int8 text "
                          f"beyond a near-tie: {line}")
            else:
                check(res["cer"] <= res["cer_float_route"] + INT8_CER_TOL
                      and res["lines_differing_from_float"]
                      <= INT8_LINES_DIFFER,
                      f"demo_hard_int8 {route} on its own calibration: {res}")
            out[key] = res
    # greedy: the 17 sites a batch; -ss --lm-int8 adds the LM's GEMMs (mma)
    check(all(c["conv"] == c["quantize"] == c["wgmma"] + c["mma"]
              and c["wgmma"] > 0 and c["wgmma"] % TINY_WGMMA == 0
              and (not key.startswith("greedy")
                   or c == i1_per(TINY_SITES, TINY_WGMMA,
                                  c["wgmma"] // TINY_WGMMA))
              for key, c in counts.items()),
          f"demo_hard_int8 I1 launches {counts}")
    emit({"phase": "demo_hard_int8", "model": "hctr-tiny (trained, f32)",
          "lm": "char 128d/3L (trained, f32, int8 step)",
          "lines": len(files), "batch": ref["batch"],
          "cer_tolerance": INT8_CER_TOL,
          "lines_differ_limit": INT8_LINES_DIFFER, "launches": counts,
          **out})
    return counts


def eval_int8_commands(dev, files, truth, batch: int) -> dict:
    """The eval CLI's int8 commands (``EVAL_INT8_COMMANDS``: RESULTS.md's
    greedy and LM ``-ss`` commands with ``--int8``, and ``--lm-int8`` on the
    LM one), recognizer in bf16: each CER within ``INT8_EVAL_CER_TOL`` of
    the JAX eval's at the same command (``int8.json``), the lines that
    differ from its texts reported, and I1 launched on each: the 17 sites a
    batch, and the LM step's ``2 * layers + 1`` products on the LM
    command."""
    import io
    from handwritten_chinese_ocr_samples_torch.cli import test as eval_cli
    with open(os.path.join(DEMO_ASSETS, "int8.json"), encoding="utf-8") as f:
        ref = json.load(f)["eval"]
    check(ref["files"] == files, "int8.json's eval split differs")
    n_batches = len(files) // batch
    out = {}
    for name, (flags, jax_name) in EVAL_INT8_COMMANDS.items():
        argv = ["-m", "hctr-tiny", "-f", f"{DEMO_ASSETS}/hctr_tiny.pt",
                "-i", DEMO_HARD, "-bm", "-b", str(batch), "-tv",
                "-d", str(dev), *flags]
        buf = io.StringIO()
        reset_i1()                # ---- main path: the int8 eval CLI
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = eval_cli.main(argv)
        wall = time.perf_counter() - t0
        launched = i1_counts()    # ---- end of main path
        text = buf.getvalue()
        texts = [ln[5:] for ln in text.splitlines() if ln.startswith("PRE: ")]
        check(len(texts) == len(files) and "[int8] calibrated 17 conv sites"
              in text, f"eval {name}: {len(texts)} texts")
        jax_texts, jax_cer = ref[jax_name]["texts"], ref[jax_name]["cer"]
        differ = [i for i in range(len(files)) if texts[i] != jax_texts[i]]
        for i in differ:
            emit({"phase": "eval_demo_hard_difference", "command": name,
                  "file": files[i], "card": texts[i], "jax": jax_texts[i]})
        per_batch = TINY_SITES + (2 * LM_HARD_LAYERS + 1
                                  if "--lm-int8" in flags else 0)
        check(launched["conv"] == launched["quantize"]
              >= per_batch * n_batches
              and (launched["conv"] == per_batch * n_batches
                   or "--lm-int8" in flags)
              and launched["wgmma"] == TINY_WGMMA * n_batches
              and launched["mma"] == launched["conv"] - launched["wgmma"],
              f"eval {name}: I1 launches {launched}")
        out[name] = {"argv": " ".join(argv[:-len(flags)] + flags),
                     "cer": result, "cer_check": cer(texts, truth),
                     "gate": {"jax_eval_int8_cer_same_command": jax_cer,
                              "abs_diff": abs(result - jax_cer),
                              "tolerance": INT8_EVAL_CER_TOL},
                     "lines_differing_from_jax_int8": len(differ),
                     "wall_s_with_load": wall, "i1_launches": launched}
        check(abs(result - jax_cer) <= INT8_EVAL_CER_TOL,
              f"eval {name}: CER {result} vs the JAX eval's {jax_cer}")
    return out


def phase_eval_int8(dev) -> dict:
    """``eval_int8_commands`` alone (``--int8``), on the eval split of
    ``texts.json``."""
    with open(os.path.join(DEMO_ASSETS, "texts.json"), encoding="utf-8") as f:
        ref = json.load(f)["eval"]
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    out = eval_int8_commands(dev, ref["files"],
                             [labels[n] for n in ref["files"]], ref["batch"])
    emit({"phase": "eval_int8", **out})
    return out


# ------------------------------------------------------------ training
def tiny_trainee(dev, **kw):
    """``hctr-tiny`` on demo/hard's classes, f32 parameters, on ``dev``."""
    model, characters = get_model_info(
        "hctr-tiny", chars_list_file=f"{DEMO_HARD}/chars_list.txt", **kw)
    return model.to(dev), characters


def parity_batch(classes: int) -> dict:
    """A seeded batch of the train step's layout (numpy)."""
    rng = np.random.default_rng(PARITY_SEED)
    B, W, L = PARITY_B, PARITY_W, PARITY_L
    lengths = rng.integers(4, L + 1, B)
    return {"images": rng.uniform(-1, 1, (B, 128, W, 1)).astype(np.float32),
            "labels": rng.integers(1, classes - 1, (B, L)).astype(np.int32),
            "label_paddings": (np.arange(L)[None] >= lengths[:, None]
                               ).astype(np.float32),
            "widths": rng.integers(W // 2, W + 1, B).astype(np.int32)}


def step_batch(batch: dict, dev) -> dict:
    """Images and labels on ``dev``, the CTC lengths on the CPU."""
    return {"images": torch.from_numpy(batch["images"]).to(dev),
            "labels": torch.from_numpy(batch["labels"]).to(dev),
            "label_paddings": torch.from_numpy(batch["label_paddings"]),
            "widths": torch.from_numpy(batch["widths"])}


def zero_in_exact_arithmetic(name: str) -> bool:
    """A conv bias that feeds a train-mode BatchNorm (all but the head's)."""
    return name.endswith("bias") and "conv" in name


def one_step(dev, kind: str, weights: dict, batch: dict,
             dtype=torch.float32) -> dict:
    """The gradients of ``batch``'s loss, then one train step of ``kind``,
    from ``weights`` on ``dev``, activations in ``dtype``; all on the CPU
    after."""
    from handwritten_chinese_ocr_samples_torch.ops.ctc import ctc_loss_mean
    from handwritten_chinese_ocr_samples_torch.train import step as tstep
    model, _ = tiny_trainee(dev, stage_drop=(0.0,) * 4, block_drop=0.0,
                            dtype=dtype)
    model.load_state_dict(weights)
    model.train()
    b = step_batch(batch, dev)
    names, params = zip(*model.named_parameters())
    loss = ctc_loss_mean(model(b["images"]), b["labels"],
                         b["label_paddings"])
    grads = {n: g.cpu() for n, g in zip(names, torch.autograd.grad(loss,
                                                                   params))}
    state = tstep.TrainState.create(
        model, tstep.make_optimizer(kind, lr=PARITY_LR[kind]))
    state, metrics = tstep.make_train_step()(state, b, 0)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "skipped": float(metrics["skipped"]), "grads": grads,
            "new": {k: v.cpu() for k, v in model.state_dict().items()}}


def adam_flips(grads: dict, weights: dict, noise: dict) -> dict:
    """Elements whose Adam direction u (clipped gradient + weight decay)
    may change sign between two f32 evaluations: |u| under
    ``ADAM_FLIP_SHARE`` of their tensor's largest (the model's, for a conv
    bias that feeds a BatchNorm), or under ``F32_NOISE_MARGIN`` times the
    tensor's largest f32 gradient error ``noise`` (clipped alike)."""
    total = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()])).item()
    f = min(1.0, 5.0 / total)
    u = {n: f * g + 1e-4 * weights[n] for n, g in grads.items()}
    top = max(v.abs().max().item() for v in u.values())
    return {n: v.abs() < max(
        ADAM_FLIP_SHARE * (top if zero_in_exact_arithmetic(n)
                           else v.abs().max().item()),
        F32_NOISE_MARGIN * f * noise[n]) for n, v in u.items()}


def dropout_on_card(dev) -> dict:
    """``dropout_recompute`` on the card: its backward multiplies by the
    forward's mask, exactly, and its keep fraction at each rate of
    ``DROPOUT_RATES`` lies within 4 sigma of ``1 - ceil(rate * 65536) /
    65536``."""
    import math
    from handwritten_chinese_ocr_samples_torch.ops.dropout import (
        dropout_recompute, fold_in, keep_mask)
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.rand(64, 1024, 257, generator=g, device=dev) + 0.5
         ).requires_grad_()
    dy = torch.rand(x.shape, generator=g, device=dev) + 0.5
    y = dropout_recompute(x, fold_in(7, 1), 0.3)
    y.backward(dy)
    scale = torch.tensor(1 / 0.7).item()
    kept = y.detach() != 0
    check(torch.equal(x.grad, torch.where(kept, dy * scale, 0.0)),
          "dropout: the backward's mask is not the forward's")
    out = {"backward_mask_equal": True, "elements": x.numel(),
           "kept_share_0.3": kept.float().mean().item()}
    for rate in DROPOUT_RATES:
        share = keep_mask(fold_in(11, int(rate * 10)), (DROPOUT_N,), rate,
                          dev).float().mean().item()
        p = 1 - math.ceil(rate * 65536) / 65536
        sigma = math.sqrt(p * (1 - p) / DROPOUT_N)
        check(abs(share - p) <= 4 * sigma,
              f"dropout {rate}: keep share {share} vs {p} +- 4 x {sigma}")
        out[f"rate_{rate}"] = {"keep_share": share, "expected": p,
                               "sigmas": (share - p) / sigma}
    return out


def step_errors(got: dict, want: dict, flips: dict, lr: float) -> dict:
    """How far one step's results ``got`` lie from ``want``: the loss
    (relative), the gradients (of each tensor's largest |g|, of the
    model's for a conv bias that feeds a BatchNorm), the new parameters
    (over lr; the elements of ``flips`` apart, counted, with their own
    largest error) and the new running statistics."""
    top = max(g.abs().max().item() for g in want["grads"].values())
    grad = 0.0
    for n, g in want["grads"].items():
        scale = top if zero_in_exact_arithmetic(n) else g.abs().max().item()
        grad = max(grad, (got["grads"][n] - g).abs().max().item() / scale)
    param, flip, n_flips, stat = 0.0, 0.0, 0, 0.0
    for n, w in want["new"].items():
        diff = (got["new"][n] - w).abs()
        if n.endswith(("running_mean", "running_var")):
            stat = max(stat, diff.max().item())
            continue
        if n in flips:
            n_flips += int(flips[n].sum())
            if flips[n].any():
                flip = max(flip, diff[flips[n]].max().item() / lr)
            diff = diff[~flips[n]]
        if diff.numel():
            param = max(param, diff.max().item() / lr)
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_of_max": grad, "param_over_lr": param, "stat": stat,
            "flip_prone_left_out": n_flips, "flip_prone_over_lr": flip}


def phase_train_parity(dev) -> dict:
    """One SGD and one Adam step of ``hctr-tiny`` (f32, dropout 0) from the
    same seeded weights on the card and on the CPU, and on the CPU with
    f64 activations (the reference): the card's loss, gradients, new
    parameters and new running statistics lie within the ``TRAIN_*_TOL``
    tolerances of the reference, or within ``F32_NOISE_MARGIN`` times the
    CPU's f32 distance from it where that is larger (a ReLU input within
    f32 rounding of 0 flips between two f32 evaluations, which moves the
    gradients of the layers below it by up to a few 1e-3 of their largest
    value). Adam's first step moves each element by about lr * sign(u), so
    the elements whose sign the f32 noise can turn (``adam_flips``) are
    counted and held to 2 lr apart. Then dropout's properties on the
    card."""
    from handwritten_chinese_ocr_samples_torch.utils.weights import (
        init_state_dict)
    model, characters = tiny_trainee("cpu")
    weights = init_state_dict(model, torch.Generator().manual_seed(0))
    batch = parity_batch(len(characters) + 2)
    tol = {"loss_rel": TRAIN_LOSS_TOL, "grad_of_max": TRAIN_GRAD_TOL,
           "param_over_lr": TRAIN_PARAM_TOL, "stat": TRAIN_STAT_TOL}
    out = {}
    for kind, lr in PARITY_LR.items():
        ref = one_step("cpu", kind, weights, batch, torch.float64)
        cpu = one_step("cpu", kind, weights, batch)
        card = one_step(dev, kind, weights, batch)
        check(ref["skipped"] == cpu["skipped"] == card["skipped"] == 0.0,
              f"train_parity {kind}: a step was skipped")
        noise = {n: (cpu["grads"][n] - g).abs().max().item()
                 for n, g in ref["grads"].items()}
        flips = (adam_flips(ref["grads"], weights, noise) if kind == "Adam"
                 else {})
        err_card = step_errors(card, ref, flips, lr)
        err_cpu = step_errors(cpu, ref, flips, lr)
        bound = {k: max(t, F32_NOISE_MARGIN * err_cpu[k])
                 for k, t in tol.items()}
        for k, b in bound.items():
            check(err_card[k] <= b, f"train_parity {kind}: {k} "
                  f"{err_card[k]} over {b} (the CPU's f32: {err_cpu[k]})")
        check(err_card["flip_prone_over_lr"] <= 2 * (1 + 1e-3),
              f"train_parity {kind}: a flip-prone element moved "
              f"{err_card['flip_prone_over_lr']} lr")
        out[kind] = {"lr": lr, "loss_f64": ref["loss"],
                     "loss_cpu": cpu["loss"], "loss_card": card["loss"],
                     "grad_norm_f64": ref["grad_norm"],
                     "grad_norm_card": card["grad_norm"],
                     "card_vs_f64": err_card, "cpu_f32_vs_f64": err_cpu,
                     "card_vs_cpu_f32": step_errors(card, cpu, flips, lr),
                     "bound": bound}
    out["dropout"] = dropout_on_card(dev)
    emit({"phase": "train_parity", "model": "hctr-tiny (f32, dropout 0)",
          "reference": "the port on the CPU, f64 activations",
          "batch": PARITY_B, "width": PARITY_W, "tolerances": tol,
          "f32_noise_margin": F32_NOISE_MARGIN,
          "adam_flip_share": ADAM_FLIP_SHARE, **out})
    return out


def train_flops(model, batch: int, width: int, dev) -> float:
    """Multiply-adds x 2 of one forward at ``(batch, width)``: the
    convolutions' from their output shapes, the SE gates' and the head's
    from their weights; a train step is 3 times this (forward, and twice
    that for the backward)."""
    from handwritten_chinese_ocr_samples_torch.models.hctr import (
        Conv, SELayer)
    total = [0.0]

    def conv_hook(m, args, out):
        total[0] += 2.0 * out.numel() * m.weight[0].numel()

    def se_hook(m, args, out):
        total[0] += 2.0 * args[0].shape[0] * (m.fc1.weight.numel()
                                              + m.fc2.weight.numel())

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv)
                                     else se_hook)
             for m in model.modules() if isinstance(m, (Conv, SELayer))]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = model(torch.zeros(batch, 128, width, 1, device=dev))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    total[0] += 2.0 * logits.shape[0] * logits.shape[1] * \
        model.linear.weight.numel()
    return total[0]


def timed_steps(trainer, batches, seed: int):
    """Train steps on ``batches``, a CUDA event before each and after the
    last; returns (metrics of each step, the events)."""
    events, metrics = [], []
    for batch in batches:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        trainer.state, m = trainer.train_step(trainer.state, batch, seed)
        metrics.append(m)
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    torch.cuda.synchronize()
    return metrics, events


def steps_ms(events) -> list:
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def profile_steps(trainer, batches, seed: int) -> tuple:
    """Train steps under torch.profiler: (device busy ms, kernel launches,
    the 12 largest kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            trainer.state, _ = trainer.train_step(trainer.state, batch, seed)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return (sum(ms for _, ms, _ in kernels),
            sum(n for _, _, n in kernels), top_kernels(kernels))


def host_syncs(fn) -> dict:
    """The synchronising CUDA calls of ``fn()`` (torch's sync debug mode),
    counted by the innermost line outside torch that made them."""
    import traceback
    import warnings
    calls, inside = {}, [False]

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f"{os.sep}torch{os.sep}" not in f.filename
                  and not f.filename.endswith("warnings.py")]
        where = (f"{os.path.relpath(frames[-1].filename)}:{frames[-1].lineno}"
                 if frames else f"{filename}:{lineno}")
        calls[where] = calls.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True        # setting the mode may synchronise itself
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return calls


def phase_train_full(dev) -> dict:
    """``FULL_STEPS`` train steps of the full-width ``hctr`` (bf16 compute,
    f32 parameters, dropout on) on demo/full's training lines through the
    port's ``Trainer`` (its loader, its batch preparation that overlaps the
    next batch's copy to the card with the step, its train step) at
    demo/full's recipe: ms a step, lines/s and the share of the bf16 peak
    over steps 11-30 (CUDA events at the step boundaries), peak memory, the
    device's idle share over the last ``FULL_REPLAYED`` batches taken again
    under torch.profiler (busy time there against the same batches' time
    unprofiled), the same batches with ``remat``, and the synchronising
    CUDA calls of one step. Every loss is finite, no step is skipped, the
    loss falls from step 1 to the last, and none of K1-K4 launches."""
    from handwritten_chinese_ocr_samples_torch.ops.dropout import fold_in
    from handwritten_chinese_ocr_samples_torch.train.trainer import (
        Trainer, TrainerConfig)
    steps = FULL_STEPS
    model, characters = get_model_info(FULL_MODEL, data_dir=FULL_DATA,
                                       dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(TrainerConfig(data=FULL_DATA, model_type=FULL_MODEL,
                                    device=str(dev), **FULL_RECIPE),
                      model, characters)
    seed = fold_in(trainer.dropout_seed, 0)      # epoch 0's dropout seed
    loader = trainer._loader("train", shuffle=True)
    loader.set_epoch(0)
    # the trainer's largest bucket is the last multiple of bucket_step
    # within max_width: wider lines are cut to it, their labels left whole
    largest = max(loader.collate_fn.bucket_spec.widths)
    cropped = float((loader._item_widths() > largest).mean())
    widths, kept = [], []

    def live():
        it = trainer._device_iter(loader)
        for i, batch in zip(range(steps), it):
            widths.append(int(batch["images"].shape[2]))
            if i >= steps - FULL_REPLAYED:
                kept.append(batch)
            yield batch
        it.close()

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, events = timed_steps(trainer, live(), seed)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    skipped = sum(float(m["skipped"]) for m in metrics)
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"train_full: losses {losses}")
    check(skipped == 0, f"train_full: {skipped:.0f} steps skipped")
    check(losses[-1] < losses[0],
          f"train_full: loss {losses[0]} at step 1, {losses[-1]} at "
          f"step {steps}")
    ms = steps_ms(events)
    lines = FULL_RECIPE["batch_size"] * (steps - FULL_TIMED_FROM)
    timed_s = events[FULL_TIMED_FROM].elapsed_time(events[steps]) / 1e3
    flops = {w: 3 * train_flops(trainer.model, FULL_RECIPE["batch_size"],
                                w, dev) for w in sorted(set(widths))}
    timed_flops = sum(flops[w] for w in widths[FULL_TIMED_FROM:])
    # the last batches again: under the profiler, then with remat
    replay_ms = events[steps - FULL_REPLAYED].elapsed_time(events[steps])
    busy_ms, n_launch, top = profile_steps(trainer, kept, seed)
    trainer.model.cnn.remat = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_metrics, remat_events = timed_steps(trainer, kept, seed)
    remat_peak = torch.cuda.max_memory_allocated()
    trainer.model.cnn.remat = False
    check(all(np.isfinite(float(m["loss"])) for m in remat_metrics),
          "train_full: a remat loss is not finite")
    syncs = host_syncs(lambda: trainer.train_step(trainer.state, kept[0],
                                                  seed))
    torch.cuda.synchronize()
    launched = launch_counts()
    check(not any(launched.values()),
          f"train_full: K1-K4 launched in training: {launched}")
    by_width = {str(w): statistics.median(
        [t for t, x in zip(ms[FULL_TIMED_FROM:], widths[FULL_TIMED_FROM:])
         if x == w]) for w in sorted(set(widths[FULL_TIMED_FROM:]))}
    out = {"model": f"{FULL_MODEL} (bf16 compute, f32 parameters, dropout "
                    "on)", "params": n_params,
           "classes": len(characters) + 2, "data": f"{FULL_DATA}/train",
           "recipe": FULL_RECIPE, "steps": steps,
           "largest_bucket": largest, "lines_wider_share": cropped,
           "loss_step_1": losses[0], f"loss_step_{steps}": losses[-1],
           "losses": losses, "skipped": skipped, "widths": widths,
           "ms_per_step_median": statistics.median(ms[FULL_TIMED_FROM:]),
           "ms_per_step_median_by_width": by_width,
           "lines_per_s": lines / timed_s,
           "timed_steps": f"{FULL_TIMED_FROM + 1}-{steps}",
           "wall_s_all_steps": wall_s,
           "train_flops_per_step_by_width": {str(w): f
                                             for w, f in flops.items()},
           "bf16_peak_share": timed_flops / timed_s / BF16_OPS_PER_S,
           "peak_memory_bytes": peak,
           "profiled_steps": FULL_REPLAYED,
           "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
           "device_idle_share": (1 - busy_ms / replay_ms if busy_ms > 0
                                 else "not measured"),
           "unprofiled_ms_same_steps": replay_ms,
           "kernel_launches_profiled": n_launch, "top_kernels": top,
           "remat": {"ms_per_step_median": statistics.median(
                         steps_ms(remat_events)),
                     "ms_same_steps_plain": replay_ms,
                     "ms_same_steps": remat_events[0].elapsed_time(
                         remat_events[-1]),
                     "peak_memory_bytes": remat_peak},
           "host_syncs_in_one_step": syncs,
           "k1_k4_launches": launched}
    emit({"phase": "train_full", **out})
    return out


def phase_train_cli(dev) -> dict:
    """``cli/train.py`` as a user runs it, in a subprocess, once for each
    seed of ``JAX_CLI_ACC``: a warm start from the converted demo/hard
    weights and one epoch of demo/hard's 1200 training lines at batch 8,
    then the trainer's test evaluation. The checkpoints carry the JAX
    trainer's names, the mean test accuracy is within
    ``TRAIN_CLI_ACC_TOL`` of the JAX CLI's mean over the same seeds, and
    the eval CLI (``cli/test.py -bm -dm greedy-search``) on seed 0's
    checkpoint gives ``1 - acc``."""
    import io
    import re
    import tempfile
    from handwritten_chinese_ocr_samples_torch.cli import test as eval_cli
    accs, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for name in ("train", "test", "train_img_id_gt.txt",
                     "test_img_id_gt.txt", "chars_list.txt"):
            os.symlink(os.path.abspath(os.path.join(DEMO_HARD, name)),
                       os.path.join(data, name))
        for seed in JAX_CLI_ACC:
            out_dir = os.path.join(tmp, f"out{seed}")
            argv = ["-m", "hctr-tiny", "-d", data, "-re",
                    f"{DEMO_ASSETS}/hctr_tiny.pt", "-b", "8", "-ep", "1",
                    "--seed", str(seed), "--out-dir", out_dir]
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m",
                 "handwritten_chinese_ocr_samples_torch.cli.train", *argv],
                capture_output=True, text=True, timeout=TRAIN_CLI_TIMEOUT)
            walls[seed] = time.perf_counter() - t0
            check(run.returncode == 0, f"train_cli seed {seed}: exit "
                  f"{run.returncode}: {run.stderr[-2000:]}")
            printed = re.findall(r"epoch 0: test acc ([0-9.]+)", run.stdout)
            check(len(printed) == 1 and "warm start" in run.stdout,
                  f"train_cli seed {seed}: {run.stdout[-2000:]}")
            accs[seed] = float(printed[0])
            files = sorted(os.listdir(out_dir))
            want = sorted(["hctr-tiny_checkpoint",
                           f"hctr-tiny_1ep_{printed[0]}acc_checkpoint"])
            check(files == want, f"train_cli: files {files}, not {want}")
            if seed == 0:
                shown = " ".join(["cli.train", *argv]).replace(tmp, "<tmp>")
                checkpoints = files
                with contextlib.redirect_stdout(io.StringIO()):
                    cer = eval_cli.main(["-m", "hctr-tiny", "-f",
                                         os.path.join(out_dir,
                                                      "hctr-tiny_checkpoint"),
                                         "-i", data, "-bm", "-b", "8",
                                         "-dm", "greedy-search",
                                         "-d", str(dev)])
                check(f"{1 - cer:.4f}" == printed[0],
                      f"train_cli: eval CLI CER {cer} vs trainer acc "
                      f"{accs[0]}")
    mean = statistics.mean(accs.values())
    jax_mean = statistics.mean(JAX_CLI_ACC.values())
    check(abs(mean - jax_mean) <= TRAIN_CLI_ACC_TOL,
          f"train_cli: mean test acc {mean} ({accs}) vs the JAX CLI's "
          f"{jax_mean} ({JAX_CLI_ACC})")
    out = {"argv": shown, "test_acc": accs, "test_acc_mean": mean,
           "jax_cli_test_acc_cpu": JAX_CLI_ACC,
           "jax_cli_test_acc_mean": jax_mean,
           "abs_diff_of_means": abs(mean - jax_mean),
           "tolerance": TRAIN_CLI_ACC_TOL, "eval_cli_cer_seed0": cer,
           "checkpoints_seed0": checkpoints, "wall_s": walls}
    emit({"phase": "train_cli", **out})
    return out


# ------------------------------------------------------------------ export
def demo_hard_split():
    """demo/hard's 150 test lines in the committed texts' order: (files,
    paths, labels, the JAX engine's texts)."""
    with open(os.path.join(DEMO_ASSETS, "texts.json"), encoding="utf-8") as f:
        committed = json.load(f)
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    files = committed["files"]
    paths = [os.path.join(DEMO_HARD, "test", name) for name in files]
    return files, paths, [labels[name] for name in files], committed


def bundle_programs(out_dir: str, meta: dict, dev):
    """A recognizer bundle's loaded programs by width (one batch size) and
    its weights on ``dev``."""
    check(meta["device"] == str(dev), f"bundle traced on {meta['device']}")
    (b,) = meta["batch_sizes"]
    fns = {w: export.load_exported(
        os.path.join(out_dir, f"{meta['tag']}_b{b}_w{w}.pt2"))
        for w in meta["widths"]}
    return fns, export.load_weights(os.path.join(out_dir, meta["weights"]),
                                    dev)


def serve_programs(fns, weights, codec, items, batch: int):
    """Texts of ``[(bucket width, (1, H, W, 1) uint8)]`` from the loaded
    programs, in input order: FIFO batches of ``batch`` a bucket, the last
    padded by repetition. Returns the texts and each batch's ``(uint8
    input, chars, lengths)``."""
    groups = {}
    for i, (w, _) in enumerate(items):
        groups.setdefault(w, []).append(i)
    texts, batches = [""] * len(items), []
    dev = next(iter(weights.values())).device
    with torch.inference_mode():
        for w, idxs in sorted(groups.items()):
            for s in range(0, len(idxs), batch):
                chunk = idxs[s:s + batch]
                rows = chunk + [chunk[-1]] * (batch - len(chunk))
                u8 = torch.from_numpy(np.concatenate(
                    [items[i][1] for i in rows])).to(dev)
                chars, lengths = fns[w](weights, u8)
                batches.append((u8, chars, lengths))
                for i, t in zip(chunk, codec.compact_to_texts(
                        chars.cpu(), lengths.cpu())):
                    texts[i] = t
    return texts, batches


def check_eager(engine: ServingEngine, batches, what: str) -> None:
    """Every program batch's ``(chars, lengths)`` equal to the eager
    engine's model + ``greedy_decode_device`` on the same input."""
    with torch.inference_mode():
        for u8, chars, lengths in batches:
            want_c, want_l = greedy_decode_device(
                engine.model((u8.float() - 127.5) / 127.5),
                unknown_id=engine.codec.unknown_id)
            check(torch.equal(chars, want_c) and torch.equal(lengths, want_l),
                  f"{what}: program vs eager greedy differ at width "
                  f"{u8.shape[2]}")


def kernel_time(fn) -> tuple:
    """One call of ``fn`` (after one warm-up) under torch.profiler: the
    device time of its operations, summed, and their count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return sum(ms for _, ms, _ in kernels), sum(n for _, _, n in kernels)


def file_sizes(out_dir: str) -> dict:
    return {f: os.path.getsize(os.path.join(out_dir, f))
            for f in sorted(os.listdir(out_dir))}


def export_timed(argv) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = export_cli.main(argv)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_export(dev, codec, state) -> dict:
    """The recognizer and the LM through ``cli/export.py`` and
    ``serve/export.py``, each loaded program against its eager route:

      * the seeded full-width ``hctr`` (bf16) at ``-b 4 -w
        512,1024,1600``: on the serve phase's 16 lines every batch's
        ``(chars, lengths)`` equals the eager engine's greedy route; the
        export wall time a bucket, the files' sizes, and the loaded
        program's ms beside the eager forward + greedy at b4;
      * the same with ``--int8-calib demo/hard/data/test``: equal to the
        eager int8 model on the same calibration, 33 launches of each of
        I1's entry points a forward, counted by the custom ops;
      * demo/hard's ``hctr-tiny`` in f32 (``export_model``), float and
        int8 on the same calibration images: the 150 test lines served
        from the loaded programs equal the eager routes, the float texts
        the JAX engine's (CER 0.0829);
      * demo/hard's LM at (1, 10) x (32, 64): ``ExportedLMScorer.score``
        within ``LM_EXPORT_TOL`` a token of ``LMScorer.score`` in f32 on
        the 150 labels and over-long lines.

    Returns I1's launches on the int8 programs' main paths."""
    out = {}
    counts = {}
    images = text_lines(N_REQUESTS, seed=0)
    for kind in ("bf16", "int8"):
        out_dir = os.path.join(EXPORT_DIR, f"{EXPORT_MODEL}_{kind}")
        argv = ["-m", EXPORT_MODEL, "-f", "seed:0", "-o", out_dir, "-w",
                ",".join(map(str, WIDTHS)), "-b", str(BATCH), "-cl",
                CHARS_LIST, "--device", str(dev)]
        if kind == "int8":
            argv += ["--int8-calib", INT8_CALIB]
        res, wall = export_timed(argv)
        meta = res["model"]
        check(meta["int8"] == (kind == "int8")
              and meta["compute_dtype"] == "bfloat16",
              f"export {kind}: meta {meta}")
        fns, weights = bundle_programs(out_dir, meta, dev)
        model, _ = get_model_info(EXPORT_MODEL, chars_list_file=CHARS_LIST,
                                  dtype=torch.bfloat16)
        engine = ServingEngine(model, state, codec, widths=WIDTHS,
                               device=dev)
        if kind == "int8":
            x = torch.from_numpy(quant.calibration_images(
                INT8_CALIB, 128, WIDTHS[0])).to(dev)
            quant.calibrate_for_model(engine.model,
                                      [(x.float() - 127.5) / 127.5],
                                      announce=False)
            reset_i1()        # ---- main path: the int8 programs
        items = [engine.preprocess_array(a) for a in images]
        texts, batches = serve_programs(fns, weights, codec, items, BATCH)
        if kind == "int8":
            counts["export_int8"] = i1_counts()   # ---- end of main path
        check_eager(engine, batches, f"export {kind}")
        times = {}
        rows = [x for bw, x in items if bw == WIDTHS[-1]]
        check(bool(rows), "export: no served line in the widest bucket")
        u8 = torch.from_numpy(np.concatenate((rows * BATCH)[:BATCH]))
        for w in WIDTHS:
            xw = u8[:, :, :w].to(dev)

            def program():
                return fns[w](weights, xw)

            def eager():
                return greedy_decode_device(
                    engine.model((xw.float() - 127.5) / 127.5),
                    unknown_id=codec.unknown_id)
            with torch.inference_mode():
                # events around the call; and the device time of its
                # operations, summed, with their count (device_ms cannot
                # get ahead of an int8 program: it enqueues more launches
                # than a stream holds, and the host waits for the card)
                times[str(w)] = {"program_ms": cuda_ms(program),
                                 "eager_ms": cuda_ms(eager)}
                for name, fn in (("program", program), ("eager", eager)):
                    busy, ops = kernel_time(fn)
                    times[str(w)].update({f"{name}_device_ms": busy,
                                          f"{name}_device_ops": ops})
        if kind == "int8":
            reset_i1()
            with torch.inference_mode():
                fns[WIDTHS[0]](weights, u8[:, :, :WIDTHS[0]].to(dev))
            per_forward = i1_counts()
            check(per_forward == i1_per(HCTR_SITES, HCTR_WGMMA),
                  f"export int8: I1 launches a program call {per_forward}")
            check(counts["export_int8"] == i1_per(HCTR_SITES, HCTR_WGMMA,
                                                  len(batches)),
                  f"export int8: I1 launches {counts['export_int8']} for "
                  f"{len(batches)} batches")
            out[kind + "_i1_launches_per_forward"] = per_forward
        out[kind] = {"export_s": wall,
                     "export_s_per_bucket": wall / len(meta["artifacts"]),
                     "bytes": file_sizes(out_dir), "ms_b4": times,
                     "texts_nonempty": sum(bool(t) for t in texts)}
        del fns, weights, engine, model
        shutil.rmtree(out_dir)

    # demo/hard: hctr-tiny in f32 through export_model, float and int8
    files, paths, truth, committed = demo_hard_split()
    chars_file = os.path.join(DEMO_HARD, "chars_list.txt")
    tiny = torch.load(os.path.join(DEMO_ASSETS, "hctr_tiny.pt"),
                      weights_only=True)
    batch = committed["batch"]
    for kind in ("f32", "int8"):
        engine = demo_hard_engines(dev)["greedy"]
        amax = None
        if kind == "int8":
            x = torch.from_numpy(quant.calibration_images(
                INT8_CALIB, 128, WIDTHS[0])).to(dev)
            amax = quant.calibrate_for_model(
                engine.model, [(x.float() - 127.5) / 127.5], announce=False)
        model, _ = get_model_info("hctr-tiny", chars_list_file=chars_file)
        out_dir = os.path.join(EXPORT_DIR, f"hctr-tiny_{kind}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = export.export_model(model, tiny, out_dir, tag="hctr-tiny",
                                   widths=WIDTHS, batch_sizes=(batch,),
                                   unknown_id=engine.codec.unknown_id,
                                   quant=amax, device=dev)
        wall = time.perf_counter() - t0
        fns, weights = bundle_programs(out_dir, meta, dev)
        items = [engine.preprocess_bucketed(p) for p in paths]
        if kind == "int8":
            reset_i1()        # ---- main path: demo/hard's int8 programs
        texts, batches = serve_programs(fns, weights, engine.codec, items,
                                        batch)
        if kind == "int8":
            counts["export_demo_hard_int8"] = i1_counts()  # ---- end
            check(counts["export_demo_hard_int8"] == i1_per(
                TINY_SITES, TINY_WGMMA, len(batches)),
                  f"export demo/hard int8: I1 launches "
                  f"{counts['export_demo_hard_int8']}")
        check_eager(engine, batches, f"export demo/hard {kind}")
        eager, _ = engine.infer_files_batched(paths, batch_size=batch)
        check(texts == eager, f"export demo/hard {kind}: texts differ from "
              "the eager engine's")
        res = {"cer": cer(texts, truth), "export_s": wall,
               "bytes": file_sizes(out_dir)}
        if kind == "f32":
            check(texts == committed["greedy"], "export demo/hard f32: "
                  "texts differ from the JAX engine's")
        out[f"demo_hard_{kind}"] = res
        shutil.rmtree(out_dir)

    # demo/hard's LM
    out_dir = os.path.join(EXPORT_DIR, "lm")
    res, wall = export_timed([
        "-tp", os.path.join(DEMO_ASSETS, "lm"), "-o", out_dir,
        "--lm-lengths", ",".join(map(str, LM_EXPORT_LENGTHS)),
        "--lm-batch-sizes", ",".join(map(str, LM_EXPORT_BATCHES)),
        "--device", str(dev)])
    scorer = export.ExportedLMScorer(out_dir)
    live = LMScorer(*load_lm(os.path.join(DEMO_ASSETS, "lm")), device=dev)
    sents = truth + ["".join(truth[:8])]          # one past every bucket
    cut = max(LM_EXPORT_LENGTHS) - 2
    got = scorer.score(sents, char_based=True)
    want = live.score([s[:cut] for s in sents], char_based=True)
    n = np.array([min(len(s), cut) for s in sents])
    err = float((np.abs(got - want) / n).max())
    check(err <= LM_EXPORT_TOL, f"export LM: {err} a token from LMScorer")
    check(scorer.next_k_words(truth[:10], 5, char_based=True)
          == live.next_k_words(truth[:10], 5, char_based=True),
          "export LM: next_k_words differ from LMScorer's")
    out["lm"] = {"export_s": wall, "bytes": file_sizes(out_dir),
                 "sentences": len(sents), "max_abs_err_per_token": err,
                 "buckets": res["lm"]["artifacts"]}
    shutil.rmtree(out_dir)
    emit({"phase": "export", "model": EXPORT_MODEL, "batch": BATCH,
          "widths": list(WIDTHS), "i1_launches": counts, **out})
    return counts


# ---------------------------------------------------------------- LM tools
def lm_train_flops(cfg: dict, B: int, L: int) -> float:
    """Multiply-adds x 2 of one train step of a ``CharTransformerLM`` at
    ``(B, L)``, from the shapes: per layer the q, k, v and out projections
    and the two FF products over every token, the scores and the weighted
    values over the full ``L x L`` square (the port computes it before the
    mask), the tied head; a step is 3 times the forward."""
    d, dff, V, n = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], \
        cfg["n_layers"]
    tokens = B * L
    layer = 2.0 * tokens * (4 * d * d + 2 * d * dff) + 4.0 * B * L * L * d
    return 3 * (n * layer + 2.0 * tokens * d * V)


def phase_lm_train(dev) -> dict:
    """The port trains demo/hard's LM on the card with
    ``tools/make_hard_demo.train_lm``'s recipe (8000 chain lines of
    ``default_rng(7)``, 3 epochs, b64, max_len 64, d 128, 3 layers, warm-up
    200, bf16), saves it with ``save_lm`` and serves demo/hard ``-ss -lp
    0.8 -lb 0.0`` with it (CER at most ``HARD_LM_CER_TOL``); the mean NLL a
    token of it and of the JAX-trained LM on 500 held-out chain lines.
    Then 20 train steps of ``char-512x6`` (vocab 7377) at b64, L 160, bf16:
    tokens/s, ms a step, peak memory, the share of the bf16 peak. Returns
    K1-K4's launches on the ``-ss`` main path."""
    corpus = hard_corpus()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, params, tok = train_char_lm(corpus, "".join(HARD_VOCAB),
                                       dtype=torch.bfloat16, device=dev,
                                       **HARD_LM_RECIPE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = HARD_LM_RECIPE["epochs"] * (len(corpus)
                                        // HARD_LM_RECIPE["batch_size"])
    lm_dir = os.path.join(EXPORT_DIR, "lm_trained")
    save_lm(lm_dir, model, params, tok)

    files, paths, truth, committed = demo_hard_split()
    engine = demo_hard_engines(dev, lm_dir=lm_dir)["ss"]
    engine.infer_files_batched(paths[:committed["batch"]],
                               batch_size=committed["batch"])   # warm-up
    reset_launches()          # ---- main path: -ss with the port's LM
    texts, lps = engine.infer_files_batched(paths,
                                            batch_size=committed["batch"])
    counts = launch_counts()  # ---- end of main path
    ss_cer = cer(texts, truth)
    check(ss_cer <= HARD_LM_CER_TOL, f"lm_train: -ss CER {ss_cer} with the "
          "port-trained LM")
    check(counts["topk_logsoftmax"] > 0 and counts["lse_rows"] > 0,
          f"lm_train -ss launches {counts}")
    held = hard_corpus(HARD_LM_HELDOUT, seed=HARD_LM_HELDOUT_SEED)
    n_tok = sum(len(s) for s in held)
    nll = {}
    for name, spec in (("port", lm_dir),
                       ("jax", os.path.join(DEMO_ASSETS, "lm"))):
        scorer = LMScorer(*load_lm(spec), device=dev)
        nll[name] = float(-scorer.score(held, char_based=True).sum() / n_tok)
    shutil.rmtree(lm_dir)
    hard = {"lines": len(corpus), "steps": steps, "train_s": train_s,
            "ms_per_step": 1e3 * train_s / steps, "ss_cer": ss_cer,
            "ss_cer_jax_lm": cer(committed["ss"], truth),
            "ss_lines_per_s": lps,
            "ss_lines_differing_from_jax_lm": sum(
                a != b for a, b in zip(texts, committed["ss"])),
            "heldout_lines": len(held), "heldout_nll_per_token": nll}

    # char-512x6: timed steps
    cfg = get_lm_config("char-512x6")
    B, L = LM_TIMED_B, LM_TIMED_L
    big = CharTransformerLM(**cfg, dtype=torch.bfloat16).to(dev)
    weights = {k: v.to(dev) for k, v in
               seeded_lm_state_dict(cfg, LM_SEED).items()}
    tx = AdamW(lm_schedule(5e-4, 4000, 100_000))
    opt = tx.init(list(weights.values()))
    step = make_lm_train_step(big, tx)
    rng = np.random.default_rng(0)
    toks = np.full((B, L), 2, np.int64)                  # </s> fill
    toks[:, 0] = 0                                       # <s>
    toks[:, 1:L - 1] = rng.integers(4, cfg["vocab_size"], (B, L - 2))
    toks = torch.from_numpy(toks).to(dev)
    lengths = torch.full((B,), L - 2, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for _ in range(LM_WARM_STEPS):
        weights, opt, loss = step(weights, opt, toks, lengths, gen)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    for _ in range(LM_TIMED_STEPS):
        weights, opt, loss = step(weights, opt, toks, lengths, gen)
        losses.append(loss)
    events[1].record()
    torch.cuda.synchronize()
    ms = events[0].elapsed_time(events[1]) / LM_TIMED_STEPS
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"char-512x6 losses {losses}")
    flops = lm_train_flops(cfg, B, L)
    big_res = {"config": "char-512x6", "batch": B, "length": L,
               "dtype": "bfloat16", "steps": LM_TIMED_STEPS,
               "ms_per_step": ms, "tokens_per_s": B * L / ms * 1e3,
               "tflop_per_step": flops / 1e12,
               "bf16_peak_share": flops / (ms * 1e-3) / BF16_OPS_PER_S,
               "peak_mem_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
               "loss_first_last": [losses[0], losses[-1]]}
    emit({"phase": "lm_train", "demo_hard": hard, "launches_ss": counts,
          "char_512x6": big_res})
    return counts


def phase_ngram_train() -> None:
    """``cli/lm_train_ngram.py`` on the regenerated demo/hard corpus (order
    3, the demo's vocabulary, ``--hblm``): both files byte-equal to the
    committed ``demo/hard/lm/ngram.arpa`` and ``ngram.hblm``; then
    ``cli/lm_binarize.py --check``."""
    out_dir = os.path.join(EXPORT_DIR, "ngram")
    os.makedirs(out_dir, exist_ok=True)
    corpus, chars = (os.path.join(out_dir, f)
                     for f in ("corpus.txt", "chars_list.txt"))
    with open(corpus, "w", encoding="utf-8") as f:
        f.writelines(" ".join(line) + "\n" for line in hard_corpus())
    with open(chars, "w", encoding="utf-8") as f:
        f.write("\n".join(HARD_VOCAB) + "\n")
    arpa, hblm = (os.path.join(out_dir, f)
                  for f in ("ngram.arpa", "ngram.hblm"))
    t0 = time.perf_counter()
    rc = lm_train_ngram.main([corpus, arpa, "-o", "3", "--chars-list", chars,
                              "--hblm", hblm])
    train_s = time.perf_counter() - t0
    check(rc == 0, f"lm_train_ngram exited {rc}")
    equal = {}
    for name, path in (("ngram.arpa", arpa), ("ngram.hblm", hblm)):
        with open(path, "rb") as a, open(os.path.join(
                os.path.dirname(NGRAM_HARD), name), "rb") as b:
            equal[name] = a.read() == b.read()
    check(all(equal.values()), f"ngram_train: not byte-equal {equal}")
    rc = lm_binarize.main([arpa, os.path.join(out_dir, "check.hblm"),
                           "--check"])
    check(rc == 0, f"lm_binarize --check exited {rc}")
    emit({"phase": "ngram_train", "order": 3, "lines": HARD_LM_LINES,
          "train_s": train_s, "byte_equal": equal,
          "bytes": {n: os.path.getsize(os.path.join(out_dir, n))
                    for n in ("ngram.arpa", "ngram.hblm")}})
    shutil.rmtree(out_dir)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})

    t0 = time.perf_counter()
    info = _build.build_all()      # one nvcc per source, all together
    emit({"phase": "build", "libraries": info,
          "wall_s": time.perf_counter() - t0})
    if "--train" in sys.argv[1:]:    # the training phases alone
        phase_train_parity(dev)
        phase_train_full(dev)
        phase_train_cli(dev)
        return 0
    if "--int8" in sys.argv[1:]:     # the int8 phases alone
        phase_int8_kernels(dev)
        _, codec, state = recognizer()
        phase_serve_int8(dev, codec, state)
        phase_demo_hard_int8(dev)
        phase_eval_int8(dev)
        return 0
    if "--export" in sys.argv[1:]:   # the export phase alone
        _, codec, state = recognizer()
        phase_export(dev, codec, state)
        return 0
    if "--lm" in sys.argv[1:]:       # the LM tooling phases alone
        phase_lm_train(dev)
        phase_ngram_train()
        return 0
    if "--kernels" in sys.argv[1:]:  # K1-K4 and I1 alone, times first
        times = k1_times(dev)
        emit({"phase": "k1_times", **times})
        phase_lm_kernels(dev, synthetic_frame(dev), times_first=True)
        phase_int8_kernels(dev)
        phase_kernels(dev, times)
        return 0

    k_err, timing = phase_kernels(dev)
    i1 = phase_int8_kernels(dev)
    model, codec, state = recognizer()
    launches, serve_err = phase_serve(dev, model, codec, state)
    int8_paths = {"serve_int8": phase_serve_int8(dev, codec, state)}
    lm_counts, served = phase_serve_lm(dev, model, codec, state)
    lm_kernels = phase_lm_kernels(dev, served)
    lm = seeded_lm(codec)
    paths = {"serve_ss": phase_serve_ss(dev, model, codec, state, lm)}
    paths["ss_peaky"], recorded = phase_ss_peaky(dev, model, codec, state,
                                                 lm)
    del lm
    ss_kernels = phase_ss_kernels(dev, recorded)
    paths["demo_hard_ss"] = phase_demo_hard(dev)
    int8_paths.update(phase_demo_hard_int8(dev))
    phase_demo_hard_host(dev)
    paths["eval_lm_ss"], eval_int8 = phase_eval_demo_hard(dev)
    int8_paths.update(eval_int8)
    int8_paths.update(phase_export(dev, codec, state))
    phase_train_parity(dev)
    train = phase_train_full(dev)
    phase_train_cli(dev)
    paths["lm_train_ss"] = phase_lm_train(dev)
    phase_ngram_train()
    # the kernels' launches on the skip route's main paths
    skip = {name: sum(c[name] for c in paths.values())
            for name in launch_counts()}
    emit({"phase": "launches", "beam": {"topk_logsoftmax": launches},
          "lm_full_search": lm_counts, **paths, "skip_route": skip,
          "int8_conv": int8_paths, "training": train["k1_k4_launches"]})
    ss_err = {name: max([t["max_abs_err"] for key, t in ss_kernels.items()
                         if key.split("@")[0] == name] or [0.0])
              for name in skip}
    rows = [{
        "name": "topk_logsoftmax", "route": "cuda",
        "source": "handwritten_chinese_ocr_samples_torch/csrc/topk_logsoftmax.cu",
        "replaces": "handwritten_chinese_ocr_samples_tpu/ops/topk_logsoftmax.py:67",
        "launches": skip["topk_logsoftmax"],
        "max_abs_err": max(k_err, serve_err),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    for kname, src, tpu in (
            ("peek_cache_attention", "peek_attention.cu",
             "ops/peek_attention.py:70"),
            ("lse_rows", "lse_rows.cu", "ops/logits_lse.py:74"),
            ("gather_write_kv", "gather_write_kv.cu",
             "ops/cache_gather.py:109")):
        t = lm_kernels[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"handwritten_chinese_ocr_samples_torch/csrc/{src}",
            "replaces": f"handwritten_chinese_ocr_samples_tpu/{tpu}",
            "launches": skip[kname],
            "max_abs_err": max(t["max_abs_err"], ss_err[kname]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    heavy = i1["timed"][0]
    src = "handwritten_chinese_ocr_samples_torch/csrc/int8_conv.cu"
    rows.append({
        "name": "int8_conv", "route": "cuda", "source": src,
        "replaces": "handwritten_chinese_ocr_samples_tpu/models/hctr.py:59",
        "launches": sum(c["conv"] for c in int8_paths.values()),
        "launches_by_route": {r: sum(c[r] for c in int8_paths.values())
                              for r in ("wgmma", "mma")},
        "max_abs_err": i1["max_abs_err"], "ms": heavy["ms"],
        "mma_ms": heavy["mma_ms"], "plain_ms": heavy["plain_ms"],
        "bound_ms": heavy["bound_ms"], "bound_by": heavy["bound_by"],
        "library_ms": heavy["library_ms"],
        "bf16_conv_ms": heavy["bf16_conv_ms"]})
    rows.append({
        "name": "int8_quantize", "route": "cuda", "source": src,
        "replaces": "handwritten_chinese_ocr_samples_tpu/models/hctr.py:110",
        "launches": sum(c["quantize"] for c in int8_paths.values()),
        "max_abs_err": i1["quantize_max_abs_err"],
        "ms": heavy["quantize_ms"],
        "plain_ms": heavy["quantize_plain_ms"],
        "bound_ms": heavy["quantize_bound_ms"],
        "bound_by": heavy["quantize_bound_by"], "library_ms": None})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
