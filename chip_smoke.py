"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``handwritten_chinese_ocr_samples_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card, then serves seeded text-line images through ``ServingDaemon`` at the
full ``hctr`` width on the greedy and the beam route, and checks what comes
out. Every phase prints one JSON line; any failed check raises, so the exit
code is non-zero. The last line is ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the repository around it: without either it fails
before printing any result. TF32 is switched off for convolutions and matrix
products, so f32 work on the card is full f32.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.decode.beam_device import (
    beam_search_fused, beam_search_from_topk)
from handwritten_chinese_ocr_samples_torch.models.registry import get_model_info
from handwritten_chinese_ocr_samples_torch.ops import _build
from handwritten_chinese_ocr_samples_torch.ops import topk_logsoftmax as k1
from handwritten_chinese_ocr_samples_torch.ops.decode import greedy_decode_device
from handwritten_chinese_ocr_samples_torch.serve.daemon import ServingDaemon
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from handwritten_chinese_ocr_samples_torch.utils.weights import seeded_state_dict

CHARS_LIST = "demo/full/data/chars_list.txt"
WIDTHS = (512, 1024, 1600)
BATCH = 4
N_REQUESTS = 16
SEARCH_DEPTH = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores
K1_OPS_PER_LOGIT = 8           # max, sub, exp, add, sub, compare, add, top-K compare
K1_TOL = 1e-5                  # |vals|, |blank| vs plain: f32 sums in another order
FWD_TOL = 1e-4                 # f32 forward, card vs CPU: conv sums in another order


def emit(obj) -> None:
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


def compare_k1(x: torch.Tensor, k: int = SEARCH_DEPTH) -> float:
    """K1 against its plain version on the same card tensor; returns the
    largest |difference| of vals and blank."""
    got = k1.topk_logsoftmax(x, k=k)
    want = k1.topk_logsoftmax_plain(x, k=k)
    torch.cuda.synchronize()
    vals, idx, blank, n_above = got
    pv, pi, pb, pn = want
    shape = tuple(x.shape)
    check(torch.equal(idx, pi), f"K1 idx differs at {shape}")
    err = max((vals - pv).abs().max().item(), (blank - pb).abs().max().item())
    check(err <= K1_TOL, f"K1 vals/blank differ by {err} at {shape}")
    # rows with a class within K1_TOL of the prune threshold may count it
    # either way
    logp = torch.log_softmax(x, dim=-1)
    edge = ((logp - k1.PRUNE).abs() <= K1_TOL).any(-1)
    check(torch.equal(n_above[~edge], pn[~edge]), f"K1 n_above differs at {shape}")
    return err


def phase_kernels(dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(0)
    D = 7375
    errs = []
    for shape in [(8, 1024, D), (3, 1600, D)]:
        errs.append(compare_k1(torch.randn(shape, device=dev, generator=g)))
    # ties: values on a coarse grid repeat the maximum within most rows, and
    # the first rows of each sample are constant
    ties = torch.randint(0, 6, (4, 256, D), device=dev, generator=g).float()
    ties[:, :8] = 1.5
    errs.append(compare_k1(ties))

    B, T = 8, 1024
    x = torch.randn((B, T, D), device=dev, generator=g)
    ms = cuda_ms(lambda: k1.topk_logsoftmax(x, k=SEARCH_DEPTH))
    plain_ms = cuda_ms(lambda: k1.topk_logsoftmax_plain(x, k=SEARCH_DEPTH))
    library_ms = cuda_ms(
        lambda: torch.topk(torch.log_softmax(x, dim=-1), SEARCH_DEPTH, dim=-1))
    rows = B * T
    bytes_moved = rows * D * 4 + rows * SEARCH_DEPTH * 8 + rows * 8
    ops = rows * D * K1_OPS_PER_LOGIT
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    timing = {"shape": [B, T, D], "k": SEARCH_DEPTH, "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_us": max(t_bytes, t_ops) * 1e6,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit({"phase": "kernels", "max_abs_err": max(errs), **timing})
    return max(errs), timing


def phase_serve(dev: torch.device):
    model, characters = get_model_info("hctr", chars_list_file=CHARS_LIST,
                                       dtype=torch.bfloat16)
    codec = CTCCodec(characters)
    n_params = sum(p.numel() for p in model.parameters())
    check(codec.num_classes == 7375, f"{codec.num_classes} classes")
    state = seeded_state_dict(model, 0)
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
                                           len_bonus=beam.len_bonus)
                v, c, _, _ = k1.topk_logsoftmax_plain(logits, k=SEARCH_DEPTH)
                pp, lp = beam_search_from_topk(
                    v, c, unknown_id=codec.unknown_id,
                    len_bonus=beam.len_bonus)
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
            v, c, beam_size=engine.beam_size, unknown_id=unk,
            len_bonus=engine.len_bonus), reps=3, warmup=1)
    emit({"phase": "breakdown", "batch": BATCH, "width": w,
          "preprocess_ms_per_image": prep_ms, "d2h_and_join_ms": join_ms,
          "h2d_ms": h2d_ms, "forward_ms_by_width": fwd_ms,
          "greedy_decode_ms": greedy_ms, "k1_ms": k1_ms,
          "beam_search_ms": beam_ms})


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

    k_err, timing = phase_kernels(dev)
    launches, serve_err = phase_serve(dev)
    emit({"kernels": [{
        "name": "topk_logsoftmax", "route": "cuda",
        "source": "handwritten_chinese_ocr_samples_torch/csrc/topk_logsoftmax.cu",
        "replaces": "handwritten_chinese_ocr_samples_tpu/ops/topk_logsoftmax.py:67",
        "launches": launches, "max_abs_err": max(k_err, serve_err),
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_us"] / 1e3, "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
