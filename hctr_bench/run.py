"""One run of one cell of the port's benchmark, on the card it starts on.

    python3 hctr_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Looks the cell up in ``BENCHMARK.json``, builds the port
(``handwritten_chinese_ocr_samples_torch``) for it from the weights it
unpacks itself (its fusion LM through the configuration's LM plug-in,
``lms/<arch>.py``, which may draw the weights from a seed), warms the
shapes the cell's traffic uses, then drives the
traffic for ``--seconds`` (``traffic.py``): a closed loop through
``ServingEngine.infer_arrays``, or open-loop requests through
``ServingDaemon``. Afterwards it reads the peak memory, has the program's
fusion LM score the sampled texts where the LM plug-in can
(``program_logprobs``), frees the program, and holds a sample of what the
window produced against the plain reference (``reference.py``):
``correct`` is whether every compared number is within its limit
(``limits/<cell>.json``). The last line of standard output is one
JSON object; ``--trace 1`` reports the per-layer metrics (read by
``metrics/<name>.py`` from a card-only profiler trace of the window, the
benchmark's own spans, and the port's counters and spans that a metric
declares) instead of the end-to-end ones.

Exits non-zero, printing no result, where there is no card (or fewer than
the cell asks for) and where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from concurrent.futures import wait as wait_futures  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# build and kernel caches of the program stay inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(HERE, "cache", _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import assets  # noqa: E402
import reference as ref  # noqa: E402
import roofline  # noqa: E402
import system  # noqa: E402
import trace  # noqa: E402
import traffic as tr  # noqa: E402
from manifest import Manifest, declared  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax",
          "handwritten_chinese_ocr_samples_tpu"}
CLOSE_WAIT_S = 60.0   # an open-loop request may finish this long past the close
REF_BLOCK = 8         # reference rows a forward
# the longest continuation that ``lm_gap`` scores: the skip search's longest
# LM row, a run of ``run_max`` = 8 committed tokens (an ambiguous frame's
# peek rows hold 1 + ``suffix_frames`` = 5)
LM_ROW_MAX = 8
WARM_OPEN_S = 1.0     # set-up drives an open-loop cell's daemon this long


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Cell:
    """One cell: ``setup`` builds and warms the program, ``window`` drives
    the traffic, ``sample`` takes what the check reads from the window's
    output, ``judge`` holds it against the reference."""

    def __init__(self, manifest: Manifest, name: str, device,
                 control: bool = False, lm_int8: bool = False):
        self.name = name
        self.spec = manifest.cell(name)
        self.config = manifest.config(self.spec["config"])
        self.traffic = manifest.traffic(self.spec["traffic"])
        self.limits = manifest.limits(name)
        # the fusion LM's plug-in (``lms/<arch>.py``)
        self.lm = (manifest.lm(self.config["lm"]) if "lm" in self.config
                   else None)
        # ``lm_gap``'s program side: the plug-in's optional hook, on the LM
        # route
        self.lm_hook = (getattr(self.lm, "program_logprobs", None)
                        if self.traffic["route"] == "ss" else None)
        if "lm_gap" in self.limits and self.lm_hook is None:
            raise ValueError(
                f"limits/{name}.json names lm_gap, which only a cell on the "
                f"LM route whose LM plug-in has program_logprobs reads")
        self._ref_lm = None
        self.metrics = manifest.metrics(manifest.per_layer(name))
        self.counter_paths, self.want_spans = declared(
            self.metrics.values())
        self.device = torch.device(device)
        self.control = control
        self.lm_int8 = lm_int8
        c, t = self.config, self.traffic
        self.names, self.lines = assets.read_lines(t["lines"])
        labels = assets.read_labels(t["labels"])
        self.labels = [labels[n] for n in self.names]
        self.own_widths = [int(a.shape[1]) for a in self.lines]
        self.buckets = [ref.bucket(w, c["widths"]) for w in self.own_widths]
        self.classes = ref.Classes(assets.read_chars(c["chars_list"]))
        self.engine = None

    # ---------------------------------------------------------- set-up
    def setup(self) -> None:
        c, t = self.config, self.traffic
        self.state = assets.load_state(c["weights"])
        self.lm_state = (self.lm.load_state(c["lm"], self.device)
                         if t["route"] == "ss" else None)
        program_control = self.control and c["control"]["kind"] == "program"
        self.engine = system.build_engine(
            c, t, self.state, self.lm, self.lm_state,
            assets.repo_path(c["chars_list"]), self.device,
            int8=program_control, lm_int8=program_control or self.lm_int8)
        if self.engine._int8:
            # an int8 engine calibrates on the first batch it serves
            imgs, width = self.calibration_lines()
            self.engine.infer_batch(system.pad_for_engine(
                self.engine, imgs, width))
        self.recorder = system.Recorder(self.engine.model)
        self.engine.model = self.recorder
        # the check's matching runs in the warm-up as in the window, on the
        # first batch of each bucket
        self.watch([i for w in sorted(set(self.buckets))
                    for i in [j for j, b in enumerate(self.buckets)
                              if b == w][:t["batch_size"]]])
        for _ in range(t["warm_passes"]):
            if t["kind"] == "closed":
                self.engine.infer_arrays(self.warm_lines(),
                                         batch_size=t["batch_size"])
            else:
                for w in sorted(set(self.buckets)):
                    rows = [a for a, b in zip(self.lines, self.buckets)
                            if b == w][:t["batch_size"]]
                    rows += [rows[-1]] * (t["batch_size"] - len(rows))
                    self.engine.infer_batch(
                        system.pad_for_engine(self.engine, rows, w))
        if t["kind"] == "open":
            # the daemon's own path (its thread, partial flushes padded),
            # driven as the window drives it
            self._open(0, WARM_OPEN_S)
        self.sync()

    def watch(self, lines) -> None:
        """Have the recorder keep the features of ``lines``."""
        self.recorder.watch({i: torch.from_numpy(ref.pad_line(
            self.lines[i], self.config["img_height"],
            self.config["widths"])).to(self.device) for i in lines})

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calibration_lines(self) -> tuple:
        """The first lines of the calibration folder, and their width."""
        cal = self.config["calibration"]
        _, imgs = assets.read_lines(cal["folder"])
        return imgs[:cal["lines"]], cal["width"]

    def warm_lines(self) -> list:
        """One full batch of each width bucket the lines fall in; every
        line, in name order, where the traffic says ``warm_all`` (the LM
        search sizes itself, grow-only, from the batches it has seen)."""
        if self.traffic.get("warm_all"):
            return list(self.lines)
        bs, out = self.traffic["batch_size"], []
        for w in sorted(set(self.buckets)):
            rows = [a for a, b in zip(self.lines, self.buckets) if b == w]
            out += (rows * bs)[:bs]
        return out

    # ---------------------------------------------------------- window
    def windows(self, seed: int, seconds: float, traced: bool) -> tuple:
        """A run's windows: the one its end-to-end metrics or, ``traced``,
        its per-layer metrics read (with the benchmark's spans and what the
        cell's metrics declare), and then, ``traced``, the one under the
        card's profiler (None otherwise)."""
        out = self.window(seed, seconds, spans=traced)
        return out, (self.window(seed, seconds, profile=True)
                     if traced else None)

    def window(self, seed: int, seconds: float, spans: bool = False,
               profile: bool = False,
               program_spans: bool | None = None) -> dict:
        """Drive the traffic of ``seed`` for ``seconds`` and keep what the
        check reads. ``spans`` times the forward and the engine's
        preprocessing, and takes the window's change of the port's
        counters that the cell's metrics declare and, where one of them
        asks for them, the port's spans (``program_spans``, where given,
        says whether to keep them); ``profile`` traces the card instead of
        keeping what the check reads."""
        if program_spans is None:
            program_spans = spans and self.want_spans
        paths = self.counter_paths if spans else {}
        rec = self.recorder
        plan = self.plan(seed, seconds)
        self.watch([] if profile else plan["lines"])
        rec.events, rec.shapes = [], []
        rec.timed = spans
        pre_us: list = []
        if spans:
            original = self.engine.preprocess_array

            def timed_preprocess(a):
                t0 = time.perf_counter_ns()
                out = original(a)
                pre_us.append((time.perf_counter_ns() - t0) / 1e3)
                return out
            self.engine.preprocess_array = timed_preprocess
        before = system.launch_counts()
        marks = system.read_counters(paths)
        run = (self._closed if self.traffic["kind"] == "closed"
               else self._open)
        with system.program_spans(program_spans) as records, \
                trace.card_profile(profile) as prof:
            out = run(seed, seconds)
            self.sync()
            out["trace_window_s"] = time.perf_counter() - out["t_start"]
        if spans:
            del self.engine.preprocess_array
        rec.timed = False
        after = system.launch_counts()
        out["counters"] = {k: after[k] - before[k] for k in after}
        out["deltas"] = {k: v - marks[k]
                         for k, v in system.read_counters(paths).items()}
        out["spans"] = records
        out["preprocess_us"] = pre_us
        out["forward_ms"] = rec.forward_ms() if spans else []
        out["forward_shapes"] = list(rec.shapes)
        out["prof"] = prof
        out["plan"] = plan
        out["found"] = rec.found()
        return out

    def _closed(self, seed: int, seconds: float) -> dict:
        t = self.traffic
        served = defaultdict(set)
        done, chunk, ids = 0, 0, []
        t_start = time.perf_counter()
        while True:
            order = tr.chunk_order(seed, self.buckets, t["batch_size"],
                                   chunk)
            texts, _ = self.engine.infer_arrays(
                [self.lines[i] for i in order], batch_size=t["batch_size"])
            for i, s in zip(order.tolist(), texts):
                served[i].add(s)
            done += len(order)
            ids += order.tolist()
            chunk += 1
            if time.perf_counter() - t_start >= seconds:
                break
        self.sync()
        window_s = time.perf_counter() - t_start
        return {"t_start": t_start, "window_s": window_s, "attempted": done,
                "failed": 0, "done": done, "served": served,
                "line_ids": ids}

    def _open(self, seed: int, seconds: float) -> dict:
        t = self.traffic
        due, line_of = tr.open_schedule(seed, len(self.lines),
                                        t["rate_per_s"], seconds)
        n = len(due)
        daemon = system.make_daemon(self.engine, t)
        tap = system.DaemonTap(daemon)
        finished = [None] * n
        lateness = np.zeros(n)

        def done_at(k, _fut):
            finished[k] = time.perf_counter()

        futs = []
        out_mid = None
        t_start = time.perf_counter()
        try:
            for k in range(n):
                target = t_start + due[k]
                now = time.perf_counter()
                if target > now:
                    time.sleep(target - now)
                if out_mid is None and due[k] >= seconds / 2:
                    out_mid = sum(not f.done() for f in futs)
                lateness[k] = time.perf_counter() - target
                fut = daemon.submit_array(self.lines[line_of[k]])
                fut.add_done_callback(functools.partial(done_at, k))
                futs.append(fut)
            close = t_start + seconds
            if close > time.perf_counter():
                time.sleep(close - time.perf_counter())
            out_end = sum(not f.done() for f in futs)
            window_s = time.perf_counter() - t_start
            wait_futures(futs, timeout=max(
                0.0, close + CLOSE_WAIT_S - time.perf_counter()))
        finally:
            daemon.close(drain=False)
        gave_up = time.perf_counter()
        texts, lat = {}, np.empty(n)
        failed = 0
        for k, fut in enumerate(futs):
            ok = (fut.done() and not fut.cancelled()
                  and fut.exception() is None and finished[k] is not None)
            if ok:
                texts[k] = fut.result()
                lat[k] = finished[k] - (t_start + due[k])
            else:
                failed += 1
                lat[k] = gave_up - (t_start + due[k])
        thirds = np.minimum((due * 3 // seconds).astype(int), 2)
        diag = {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "p95_by_third_ms": [float(np.percentile(lat[thirds == j], 95))
                                    * 1e3 for j in range(3)
                                    if (thirds == j).any()],
                "lateness_max_ms": float(lateness.max(initial=0.0)) * 1e3,
                "outstanding_mid": out_mid, "outstanding_end": out_end}
        index = {id(f): k for k, f in enumerate(futs)}
        flush_req = [[index[id(f)] for f in fl] for fl in tap.flushes]
        return {"t_start": t_start, "window_s": window_s, "attempted": n,
                "failed": failed, "done": n - failed, "texts": texts,
                "line_of": line_of, "latency_s": lat, "lateness_s": lateness,
                "outstanding_mid": out_mid, "outstanding_end": out_end,
                "fills": tap.fills,
                "service_s": tap.service_s,
                "flush_line_widths": [[self.own_widths[line_of[k]]
                                       for k in ks] for ks in flush_req],
                "line_ids": [int(line_of[k]) for k in texts], "diag": diag}

    # ---------------------------------------------------------- check
    def plan(self, seed: int, seconds: float) -> dict:
        """What the check of a run of ``seed`` reads, drawn from the seed
        before the window, with the longest line in it: lines (a closed
        loop serves every line each chunk) or requests (open loop)."""
        n_check = self.traffic["check_lines"]
        longest = max(range(len(self.lines)),
                      key=lambda i: (self.own_widths[i], len(self.labels[i])))
        if self.traffic["kind"] == "closed":
            return {"lines": tr.check_sample(seed, range(len(self.lines)),
                                             n_check, [longest])}
        _, line_of = tr.open_schedule(seed, len(self.lines),
                                      self.traffic["rate_per_s"], seconds)
        first = [int(np.argmax(line_of == longest))] if (
            line_of == longest).any() else []
        requests = tr.check_sample(seed, range(len(line_of)), n_check, first)
        return {"requests": requests,
                "lines": sorted({int(line_of[k]) for k in requests})}

    def sample(self, out: dict) -> list:
        """``[(line, the trunk features the program gave it or None, its
        served texts)]`` of the plan's lines or requests (a request that
        never finished is in ``failed`` and has no text to judge)."""
        found = out["found"]
        if self.traffic["kind"] == "closed":
            return [(i, found.get(i), sorted(out["served"][i]))
                    for i in out["plan"]["lines"]]
        line_of, texts = out["line_of"], out["texts"]
        return [(int(line_of[k]), found.get(int(line_of[k])), [texts[k]])
                for k in out["plan"]["requests"] if k in texts]

    def free_program(self) -> None:
        self.engine = self.recorder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, lines: list, recognizer) -> dict:
        """``line -> (trunk features, logits)`` of the reference, in blocks
        of ``REF_BLOCK`` lines of one width."""
        by_width = defaultdict(list)
        for i in sorted(set(lines)):
            by_width[self.buckets[i]].append(i)
        out = {}
        for idx in by_width.values():
            for s in range(0, len(idx), REF_BLOCK):
                block = idx[s:s + REF_BLOCK]
                x = torch.stack([ref.normalise(ref.pad_line(
                    self.lines[i], self.config["img_height"],
                    self.config["widths"])) for i in block])
                feats = recognizer.features(x)
                logits = recognizer.head(feats)
                for k, i in enumerate(block):
                    out[i] = (feats[k], logits[k])
        return out

    def recognizer(self, quant_bits=None):
        c = self.config
        return ref.Recognizer(self.state, c["channels"], c["blocks"],
                              self.device, quant_bits=quant_bits)

    def reference_lm(self):
        """The configuration's plain reference LM, built once."""
        if self._ref_lm is None:
            self._ref_lm = self.lm.reference_lm(self.config["lm"],
                                                self.lm_state, self.device)
        return self._ref_lm

    def program_lm(self, picked: list) -> dict | None:
        """``lm_gap``'s program side, read before the program is freed: the
        LM that the engine's route holds, through the plug-in's
        ``program_logprobs``, over each served text of the sample as its
        LM tokens (``<s>`` first), split into a prefix, its first half and
        at least ``<s>``, and a continuation, the rest up to
        ``LM_ROW_MAX`` tokens; None where the cell has no hook."""
        if self.lm_hook is None:
            return None
        lm, rows = self.reference_lm(), []
        for _, _, texts in picked:
            for text in texts:
                tokens = lm.tokens(text)
                n = max(1, len(tokens) // 2)
                rows.append((tokens[:n], tokens[n:n + LM_ROW_MAX]))
        next_logp, cont_sum = self.lm_hook(self.engine, rows)
        return {"rows": rows, "next_logp": next_logp.float().cpu(),
                "cont_sum": cont_sum.float().cpu()}

    def judge(self, picked: list, lm_out: dict | None = None) -> dict:
        """The compared numbers of ``sample``'s output (and of
        ``program_lm``'s, where given)."""
        want = self.reference([i for i, _, _ in picked], self.recognizer())
        return self.numbers(picked, want, lm_out)

    def numbers(self, picked: list, want: dict,
                lm_out: dict | None = None) -> dict:
        """``feat_err``: the largest relative RMS difference of a line's
        trunk features from the reference's (its precision);
        ``token_gap``: the widest gap by which a served character's logit
        lies below the reference's best (``reference.token_gap``);
        ``score_loss`` on the LM route (``_score_loss``); ``lm_gap`` where
        ``lm_out`` holds the program's LM log-probs (``_lm_gap``)."""
        cls = self.classes
        errs = [float((f.to(want[i][0].device).float() - want[i][0]).norm()
                      / want[i][0].norm()) if f is not None
                else ref.UNREACHABLE for i, f, _ in picked]
        pairs = {(i, s) for i, _, texts in picked for s in texts}
        nums = {"feat_err": max(errs, default=ref.UNREACHABLE),
                "token_gap": max((ref.token_gap(want[i][1], cls.ids(s),
                                                cls.blank, cls.unknown)
                                  for i, s in pairs),
                                 default=ref.UNREACHABLE)}
        if self.traffic["route"] == "ss":
            nums["score_loss"], nums["score_best_loss"] = self._score_loss(
                picked, {i: w[1] for i, w in want.items()})
        if lm_out is not None:
            nums["lm_gap"] = self._lm_gap(lm_out)
        nums["lines_checked"] = len(picked)
        return nums

    def _score_loss(self, picked: list, logits: dict) -> tuple:
        """``(score_loss, score_best_loss)``: how far a served text's score
        lies below that of the text the reference's own search serves (the
        first of the beams that ``reference.LMSearch``, at the
        configuration's settings, ends with), and below the best of all its
        final beams and the greedy reading, by the search's objective
        ``log p_ctc + lm_panelty * log p_lm + len_bonus * length``, each
        term worked out exactly; largest over the sample. The search ranks
        by a look-ahead, not by that objective, so its first beam need not
        be its best: the second number reads how far the search itself
        falls short, the first how far the program departs from it."""
        lmc, cls = self.config["lm"], self.classes
        lm = self.reference_lm()
        search = ref.LMSearch(lm, cls, beam=lmc["beam_size"],
                              depth=lmc["search_depth"],
                              prune=math.log(lmc["prune"]),
                              lm_panelty=lmc["lm_panelty"],
                              len_bonus=lmc["len_bonus"])
        logps = [torch.log_softmax(logits[i], dim=-1) for i, _, _ in picked]
        finals = search.run(logps)
        worst = best = -float("inf")
        for (i, _, texts), logp, beams in zip(picked, logps, finals):
            served = [cls.ids(s) for s in texts]
            if any(ids is None for ids in served):
                return ref.UNREACHABLE, ref.UNREACHABLE
            greedy = tuple(ref.greedy_ids(logits[i], cls.blank, cls.unknown))
            found = list(dict.fromkeys(list(beams) + [greedy]))
            every = found + [tuple(ids) for ids in served]
            ctc = ref.ctc_logp_many(logp, every, cls.blank)
            lm_lp, _ = lm.score([search.tokens(t) for t in every])
            score = [c + lmc["lm_panelty"] * m + lmc["len_bonus"] * len(t)
                     for c, m, t in zip(ctc, lm_lp, every)]
            low = min(score[len(found):])
            worst = max(worst, score[0] - low)
            best = max(best, max(score[:len(found)]) - low)
        return worst, best

    def _lm_gap(self, got: dict) -> float:
        """The widest gap, in nats, between the program's LM log-probs over
        ``program_lm``'s rows and the reference LM's full forward (f32, TF32 off):
        over the whole vocabulary of the next token after each prefix, and
        the continuation's summed log-prob after the prefix over its
        length; largest over the rows."""
        lm, rows = self.reference_lm(), got["rows"]
        pre, nxt = lm.score([p[1:] for p, _ in rows])
        full, _ = lm.score([p[1:] + c for p, c in rows])
        gaps = (got["next_logp"].to(nxt.device) - nxt).abs().amax(-1)
        out = gaps.tolist()
        for k, (_, c) in enumerate(rows):
            if c:
                want = full[k] - pre[k]
                out[k] = max(out[k], abs(float(got["cont_sum"][k]) - want)
                             / len(c))
        return max(out, default=ref.UNREACHABLE)

    def control_reference(self, seed: int, seconds: float) -> dict:
        """The reference in the program's place at the configuration's
        control precision (``control.quant_bits``), on the lines a run of
        this seed checks, judged like the program."""
        recq = self.recognizer(self.config["control"]["quant_bits"])
        imgs, width = self.calibration_lines()
        recq.calibrate(torch.stack([ref.normalise(ref.pad_line(
            a, self.config["img_height"], [width])) for a in imgs]))
        lines = self.plan(seed, seconds)["lines"]
        got = self.reference(lines, recq)
        cls = self.classes
        picked = [(i, got[i][0], [cls.text(ref.greedy_ids(
            got[i][1], cls.blank, cls.unknown))]) for i in lines]
        return self.numbers(picked, self.reference(lines, self.recognizer()))


def correct_of(numbers: dict, limits: dict) -> tuple:
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"the limits name {missing}, which this run does "
                         f"not compute (it computes {sorted(numbers)})")
    checks, ok = {}, True
    for name, lim in limits.items():
        limit = lim["limit"]
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, checks


class Context:
    """What a per-layer metric's reader gets (``metrics/<name>.py``): of a
    window run as the end-to-end runs run it (with the benchmark's spans),
    its wall time, counters, spans, the change of the counters the metrics
    declare (``counter``), the port's spans where one asked for them
    (``spans``) and the lines it served; of a second, traced window, its
    wall time, counters, shapes, kernel sums and busy time; the frozen
    arithmetic of ``roofline.py``; and the cell's LM plug-in (``lm``:
    ``token_flops``, ``bounds``), None where the configuration has no
    LM."""

    def __init__(self, cell: Cell, out: dict, traced: dict, kernels,
                 busy_s):
        self.config = cell.config
        self.window_s = out["window_s"]
        self.counters = out["counters"]
        self.forward_ms = out["forward_ms"]
        self.preprocess_us = out["preprocess_us"]
        self.line_widths = [cell.own_widths[i] for i in out["line_ids"]]
        self.line_chars = [len(cell.labels[i]) for i in out["line_ids"]]
        self.fills = out.get("fills", [])
        self.service_s = out.get("service_s", [])
        self.flush_line_widths = out.get("flush_line_widths", [])
        self.batch_size = cell.traffic["batch_size"]
        self.trace_window_s = traced["trace_window_s"]
        self.trace_counters = traced["counters"]
        self.trace_forward_shapes = traced["forward_shapes"]
        self.kernels = kernels
        self.busy_s = busy_s
        self.roofline = roofline
        self.lm = cell.lm
        self.spans = out.get("spans", [])
        self._deltas = out.get("deltas", {})

    def counter(self, name: str):
        """The change over the window of the port's counter that a metric
        declares as ``name`` in its ``COUNTERS``."""
        if name not in self._deltas:
            raise KeyError(f"no metric of this cell declares the counter "
                           f"{name!r} (declared: {sorted(self._deltas)})")
        return self._deltas[name]

    def kernel_ms(self, part: str) -> float:
        """Device ms of the traced window's kernels whose name holds
        ``part``."""
        return sum(ms for name, (ms, _) in (self.kernels or {}).items()
                   if part in name)

    def kernel_launches(self) -> int:
        return sum(n for name, (_, n) in self.kernels.items()
                   if not name.startswith(("Memcpy", "Memset")))

    def idle_pct(self):
        if self.busy_s is None:
            return None
        return 100.0 * (1.0 - self.busy_s / self.trace_window_s)

    def line_flops(self, width: int) -> float:
        c = self.config
        return roofline.hctr_forward_flops(width, c["channels"], c["blocks"],
                                           c["num_classes"], c["img_height"])

    def forward_flops(self) -> float:
        """The forward FLOPs of every line served, each at its own width."""
        return sum(self.line_flops(w) for w in self.line_widths)


def end_to_end(cell: Cell, out: dict, setup_s: float) -> dict:
    t = cell.traffic
    m = {"setup_s": {"value": setup_s, "unit": "s"}}
    if t["kind"] == "closed":
        m[t["rate_metric"]] = {"value": out["done"] / out["window_s"],
                               "unit": "lines/s"}
    else:
        m["p95_line_ms"] = {"value": float(np.percentile(
            out["latency_s"], 95)) * 1e3, "unit": "ms"}
    return m


def per_layer(manifest: Manifest, cell: Cell, ctx: Context) -> dict:
    """The cell's per-layer metrics that find something to read."""
    metrics = {}
    for m in manifest.per_layer(cell.name):
        value = cell.metrics[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def setup_parts() -> dict:
    """What a checkout's first run pays on top of the others' set-up: the
    weights unpacked and the kernels built in this run."""
    from handwritten_chinese_ocr_samples_torch.ops import _build
    built = {k: v["seconds"] for k, v in _build.build_info.items()
             if not v["cached"]}
    return {"first_in_checkout": bool(assets.unpacked or built),
            "unpack_s": sum(assets.unpacked.values()),
            "build_s": sum(built.values()), "built": sorted(built)}


def run(args) -> dict:
    manifest = Manifest.load()
    spec = manifest.cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < spec["chips"]):
        raise SystemExit(f"{args.workload}: needs {spec['chips']} CUDA "
                         f"card(s); this machine has "
                         f"{torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    cell = Cell(manifest, args.workload, device)
    cell.setup()
    setup_s = time.perf_counter() - T_START
    out, traced = cell.windows(args.seed, args.seconds, bool(args.trace))
    peak = torch.cuda.max_memory_allocated(device)
    picked = cell.sample(out)
    t0 = time.perf_counter()
    lm_out = cell.program_lm(picked)
    lm_s = time.perf_counter() - t0
    result_device = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(device),
                     "count": spec["chips"], "memory_peak_bytes": int(peak),
                     "power_limit_w": power_limit_w()}
    extra = {}
    if args.trace:
        events = trace.device_events(traced["prof"])
        kernels = trace.device_kernels(events)
        busy_s, gaps = trace.busy_and_gaps(events)
        result_device.update(busy_s=busy_s,
                             window_s=traced["trace_window_s"])
        metrics = per_layer(manifest, cell,
                            Context(cell, out, traced, kernels, busy_s))
        extra["breakdown"] = trace.breakdown(kernels, gaps)
        del events
        traced["prof"] = None
    else:
        metrics = end_to_end(cell, out, setup_s)
        want = {m["name"] for m in manifest.end_to_end(args.workload)}
        if set(metrics) != want:
            raise SystemExit(f"{args.workload}: the traffic reports "
                             f"{sorted(metrics)}, BENCHMARK.json names "
                             f"{sorted(want)}")
    parts = setup_parts()
    cell.free_program()
    t0 = time.perf_counter()
    numbers = cell.judge(picked, lm_out)
    check_s = time.perf_counter() - t0 + lm_s
    ok, checks = correct_of(numbers, cell.limits)
    ok = ok and out["failed"] == 0 and (traced is None
                                        or traced["failed"] == 0)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return {"correct": ok, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": result_device, **extra,
            "info": {"window_s": out["window_s"], "check_s": check_s,
                     "setup": parts, **out.get("diag", {}),
                     **{k: v for k, v in numbers.items()
                        if k not in checks}},
            "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    result = run(args)
    bad = banned_modules()
    if bad:
        print(f"refused: loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
