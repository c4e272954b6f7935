"""The harness's parts that need no model: discovery by name, isolation
from JAX and the program, refusal without a card, the traffic generator,
seeded weights and the frozen arithmetic against hand counts."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import assets
import roofline as rl
import traffic as tr
from manifest import HERE, LM_FUNCTIONS, ROOT, Manifest, reader

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax",
          "handwritten_chinese_ocr_samples_tpu"}
PORT = "handwritten_chinese_ocr_samples_torch"
ASSETS = f"{PORT}/assets/demo_hard"


def test_every_name_finds_its_file():
    m = Manifest.load()
    for cell in m.cells:
        spec = m.cell(cell)
        assert m.config(spec["config"])["name"] == spec["config"]
        t = m.traffic(spec["traffic"])
        assert t["kind"] in ("closed", "open")
        limits = m.limits(cell)
        assert "feat_err" in limits and len(limits) >= 2
        assert all(lim["lower"] < lim["limit"] < lim["upper"]
                   for lim in limits.values())
        e2e = [x["name"] for x in m.end_to_end(cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.per_layer(cell)
    for metric in m.data["per_layer"]:
        assert callable(reader(metric["name"]))
        assert metric["moves"] in {x["name"] for x in m.data["end_to_end"]}
    for c in m.data["configs"]:
        assert c["file"].startswith(m.data["paths"][0] + "/")
        cfg = m.config(c["name"])
        if "lm" in cfg:
            arch = cfg["lm"].get("arch", "char-transformer")
            assert os.path.isfile(os.path.join(HERE, "lms", f"{arch}.py"))
            lm = m.lm(cfg["lm"])
            assert all(callable(getattr(lm, f)) for f in LM_FUNCTIONS)
            assert isinstance(lm.bounds, dict)


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_and_the_reference_loads_no_program():
    setup = f"import sys; sys.path[:0] = [{HERE!r}, {ROOT!r}]\n"
    harness = _modules_after(
        setup + "import run, readings, system, reference, trace, roofline\n"
        "system.launch_counts()\n"
        "from handwritten_chinese_ocr_samples_torch.serve import daemon")
    assert not harness & BANNED
    assert PORT in harness
    plain = _modules_after(setup + "import reference, roofline, traffic")
    assert not plain & (BANNED | {PORT})
    # every LM plug-in imports neither; building the program's LM loads
    # the port
    load = (setup + "import glob, os\nfrom manifest import Manifest\n"
            "m = Manifest.load()\n"
            "lms = [m.lm({'arch': os.path.basename(f)[:-3]}) for f in "
            "sorted(glob.glob(os.path.join(m.folder, 'lms', '*.py')))]\n"
            "assert lms\n")
    assert not _modules_after(load) & (BANNED | {PORT})
    # the char LM's program_logprobs, like program_lm, imports the port
    # inside it alone
    hook = (load + "lm = m.lm({'arch': 'char-transformer'})\n"
            "assert callable(lm.program_logprobs)\n")
    assert not _modules_after(hook) & (BANNED | {PORT})
    cfg = f"{ASSETS}/lm/config.json"
    build = (load + "import json\n"
             f"c = {{'config': json.load(open({cfg!r})), "
             f"'dict': '{ASSETS}/lm/dict.txt', 'dtype': 'float32', "
             "'weights': {'seed': 3}}\n"
             "lm = m.lm(c)\n"
             "lm.program_lm(c, lm.load_state(c, 'cpu'), 'cpu')")
    built = _modules_after(build)
    assert PORT in built and not built & BANNED


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "hctr_bench/run.py", "--workload", "bf16-greedy-b32",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_traffic_repeats_for_a_seed_and_differs_across_seeds():
    big = 2 ** 31 + 12345
    buckets = [1024 if i % 7 < 2 else 1600 for i in range(150)]
    a = tr.chunk_order(big, buckets, 32, 0)
    assert np.array_equal(a, tr.chunk_order(big, buckets, 32, 0))
    b = tr.chunk_order(big + 1, buckets, 32, 0)
    assert not np.array_equal(a, b)
    assert not np.array_equal(a, tr.chunk_order(big, buckets, 32, 1))
    assert sorted(a) == list(range(150))

    def batches(order):
        """The engine's batches: each bucket's lines in order, cut in 32s."""
        by = {}
        for i in order:
            by.setdefault(buckets[i], []).append(int(i))
        return sorted(tuple(sorted(v[s:s + 32])) for v in by.values()
                      for s in range(0, len(v), 32))
    assert batches(a) == batches(b)
    d1, l1 = tr.open_schedule(big, 150, 80.0, 15.0)
    d2, l2 = tr.open_schedule(big, 150, 80.0, 15.0)
    d3, l3 = tr.open_schedule(7, 150, 80.0, 15.0)
    assert np.array_equal(d1, d2) and np.array_equal(l1, l2)
    assert not np.array_equal(d1, d3) and not np.array_equal(l1, l3)
    # gaps from one set (the exponential's quantiles), in another order
    q = (np.arange(1200) + 0.5) / 1200
    gaps = np.sort(-np.log1p(-q) / 80.0)
    for d in (d1, d3):
        g = np.sort(np.diff(d))
        k = np.searchsorted(gaps, g - 1e-12)
        assert np.allclose(gaps[k], g, atol=1e-9)
        assert len(set(k.tolist())) == len(g)
    assert len(d1) == 1200 and d1[-1] < 15.0
    assert abs(len(d1) / d1[-1] - 80.0) < 2.0
    s = tr.check_sample(big, range(150), 16, [149])
    assert s == tr.check_sample(big, range(150), 16, [149]) and 149 in s


def test_seeded_state_repeats_and_each_tensor_stands_alone():
    specs = {"a": ((3, 4), 0.5), "b": ((3, 4), 0.5), "g": ((4,), "ones"),
             "z": ((2,), "zeros")}
    big = 2 ** 31 + 77
    one = assets.seeded_state(specs, big, "cpu")
    again = assets.seeded_state(specs, big, "cpu")
    assert all(torch.equal(one[k], again[k]) for k in specs)
    other = assets.seeded_state(specs, big + 1, "cpu")
    assert not torch.equal(one["a"], other["a"])
    assert not torch.equal(one["a"], one["b"])
    # drawn alone or among others, in another order: the same values
    alone = assets.seeded_state({"b": specs["b"]}, big, "cpu")
    assert torch.equal(alone["b"], one["b"])
    backwards = assets.seeded_state(dict(reversed(specs.items())), big,
                                    "cpu")
    assert all(torch.equal(one[k], backwards[k]) for k in specs)
    assert torch.equal(one["g"], torch.ones(4))
    assert torch.equal(one["z"], torch.zeros(2))
    assert 0.2 < float(one["a"].std()) < 1.0
    bf = assets.seeded_state(specs, big, "cpu", torch.bfloat16)
    assert bf["a"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        assets.seeded_state({"x": ((2,), "uniform")}, 1, "cpu")


def test_frozen_arithmetic_against_hand_counts():
    # hctr at 64 channels, one block a stage, one column, 10 classes:
    # stem 1->8, 8->8 at H 128; stage widths 16, 32, 64, 64 at H 64..8
    macs = 128 * 9 * (1 * 8 + 8 * 8)
    for cin, c, h in ((8, 16, 64), (16, 32, 32), (32, 64, 16), (64, 64, 8)):
        macs += h * 9 * (cin * c + c * c + c * c)     # conv1, conv2, stage
        if cin != c:
            macs += h * cin * c                       # 1x1 down
    se = sum(2 * c * (c // 16) for c in (16, 32, 64, 64))
    head = 4 * 64 * 10
    want = 2.0 * (macs + se + head)
    assert rl.hctr_forward_flops(1, 64, (1, 1, 1, 1), 10) == want
    assert rl.hctr_train_flops(1, 64, (1, 1, 1, 1), 10) == \
        3 * want - 2.0 * 128 * 9 * 8
    assert len(rl.hctr_conv_sites(8, 1600)) == 33
    # one token of a 2-layer d 4, ff 8, vocab 5 LM at 3 positions
    per_layer = 2 * (4 * 16 + 2 * 32) + 2 * 2 * 3 * 4
    assert rl.lm_token_flops(3, 4, 2, 8, 5) == 2 * per_layer + 2 * 4 * 5
    ms, by = rl.k1_bound(100, 1000, 10)
    assert by == "bytes" and ms == pytest.approx(
        (100 * 1000 * 4 + 100 * 88) / 3.35e12 * 1e3)
    ms, by = rl.i1_bound((8, 512, 16, 1600), 512, 3)
    assert by == "operations" and ms == pytest.approx(
        2 * 8 * 16 * 1600 * 512 * 512 * 9 / 1979e12 * 1e3)
    ms, by = rl.quantize_bound((2, 3, 4, 5))
    assert ms == pytest.approx(120 * 3 / 3.35e12 * 1e3)


def test_token_gap_and_greedy_collapse_by_hand():
    import torch
    import reference as ref
    # classes: blank 0, characters 1 and 2, unknown 3
    logits = torch.tensor([[0., 5., 1., 0.],     # 1
                           [4., 0., 0., 0.],     # blank
                           [0., 0., 6., 2.],     # 2
                           [0., 0., 6., 0.],     # 2 (held)
                           [3., 0., 0., 1.]])    # blank
    assert ref.greedy_ids(logits, 0, 3) == [1, 2]
    assert ref.token_gap(logits, [1, 2], 0, 3) == 0.0
    # "1 1": the second 1 where 2 leads by 6 (frame 2 or 3), with a
    # separator between the two 1s at frame 1 (blank, gap 0)
    assert ref.token_gap(logits, [1, 1], 0, 3) == 6.0
    # "1 2 1": 1, blank, 2, 2, then the last 1 at frame 4, 3 below the
    # blank there (different characters need no separator between)
    assert ref.token_gap(logits, [1, 2, 1], 0, 3) == 3.0
    assert ref.token_gap(logits, [], 0, 3) == 6.0          # 2 at frames 2-3
    assert ref.token_gap(logits, None, 0, 3) == ref.UNREACHABLE
    assert ref.token_gap(logits[:1], [1, 2], 0, 3) == ref.UNREACHABLE


def test_correct_of_names_what_a_run_lacks():
    import run
    ok, checks = run.correct_of({"a": 1.0, "b": 2.0}, {"a": {"limit": 1.5}})
    assert ok and checks == {"a": {"value": 1.0, "limit": 1.5}}
    with pytest.raises(ValueError, match="lm_gap"):
        run.correct_of({"a": 1.0}, {"a": {"limit": 1.5},
                                    "lm_gap": {"limit": 0.1}})


def _tiny_char_lm(seed: int = 0):
    """A random 1-layer char LM over ``a b c`` and its classes: blank 0,
    a-c 1-3, unknown 4."""
    import torch
    import reference as ref
    torch.manual_seed(seed)
    d, V = 8, 4 + 3
    cfg = {"d_model": d, "n_layers": 1, "n_heads": 2, "d_ff": 16}
    state = {"embed.weight": torch.randn(V, d), "pos_embed": torch.randn(8, d),
             "ln_f.weight": torch.ones(d), "ln_f.bias": torch.zeros(d)}
    for n in ("ln1", "ln2"):
        state[f"layer0.{n}.weight"] = torch.ones(d)
        state[f"layer0.{n}.bias"] = torch.zeros(d)
    for n, (o, i) in {"attn.query": (d, d), "attn.key": (d, d),
                      "attn.value": (d, d), "attn.out": (d, d),
                      "ff1": (16, d), "ff2": (d, 16)}.items():
        state[f"layer0.{n}.weight"] = torch.randn(o, i) / 3
        state[f"layer0.{n}.bias"] = torch.randn(o) / 3
    lm = ref.CharLM(state, cfg, ["<s>", "<pad>", "</s>", "<unk>", "a", "b",
                                 "c"], "cpu")
    return lm, ref.Classes(["a", "b", "c"])


def test_lm_search_one_class_frames_by_hand():
    """A frame where one class alone lies above the prune updates each beam
    in place by the skip search's rules: a blank keeps ``pnb``; a repeat of
    the beam's last character is appended where ``pb`` is live, else folded
    into it with the blank's log-prob; beams of one prefix stay apart."""
    import math
    import reference as ref
    lm, cls = _tiny_char_lm()
    search = ref.LMSearch(lm, cls, beam=4, depth=3, prune=-5.0,
                          lm_panelty=0.5, len_bonus=0.0)
    inf = -math.inf
    beams = [((1,), -1.0, -2.0), ((2,), inf, -0.5)]
    assert search._fast(beams, 0, -0.1, -0.1) == [
        ((1,), ref._lae(-1.0, -2.0) - 0.1, -2.0), ((2,), -0.6, -0.5)]
    assert search._fast(beams, 1, -0.2, -3.0) == [
        ((1, 1), inf, -1.2), ((2, 1), inf, ref._lae(inf, -0.5) - 0.2)]
    assert search._fast(beams, 2, -0.2, -3.0) == [
        ((1, 2), inf, ref._lae(-1.0, -2.0) - 0.2), ((2,), -3.5, -0.7)]
    assert search._fast([((), 0.0, inf), ((1,), inf, -0.5)], 1, -0.3,
                        -2.0) == [((1,), inf, -0.3), ((1,), -2.5, -0.8)]


def test_lm_search_ranks_with_the_look_ahead():
    """At an ambiguous frame followed by a forced run, a beam of one keeps
    the candidate whose prefix with the next greedy characters scores best
    (``log p_ctc + lm_panelty * log p_lm(prefix + suffix) + len_bonus *
    len(prefix)``), which the forced run then extends; on the LM drawn here
    the prefix alone would rank another candidate first."""
    import torch
    import reference as ref
    # frame 0: a, b and the blank above the prune; then c, blank, a, blank,
    # b, each alone; the greedy line is a c a b
    logits = torch.full((6, 5), -30.0)
    logits[0, :3] = torch.tensor([2.0, 3.0, 2.9])
    logits[1, 3] = logits[2, 0] = logits[3, 1] = logits[4, 0] = 10.0
    logits[5, 2] = 10.0
    logp = torch.log_softmax(logits, -1)
    lp, lb = 2.0, 0.5
    picks = None
    for seed in range(40):
        lm, cls = _tiny_char_lm(seed)
        search = ref.LMSearch(lm, cls, beam=1, depth=3, prune=-6.9,
                              lm_panelty=lp, len_bonus=lb)
        cands = [(), (1,), (2,)]
        ahead = [search.tokens(c + (3, 1, 2)) for c in cands]
        alone = [search.tokens(c) for c in cands]

        def best(token_lists):
            sums, _ = lm.score(token_lists)
            score = [float(logp[0, c[0] if c else 0]) + lp * m + lb * len(c)
                     for c, m in zip(cands, sums)]
            return cands[max(range(3), key=score.__getitem__)]
        if best(ahead) != best(alone):
            picks = best(ahead), best(alone)
            break
    assert picks is not None
    beams, = search.run([logp])
    assert beams == [picks[0] + (3, 1, 2)]


def test_lm_search_finds_the_best_text_by_brute_force():
    """With a beam wide enough to keep every prefix and every frame
    searched, the reference's LM-fused search ends with the text that
    maximises ``log p_ctc + lm_panelty * log p_lm + len_bonus * length``
    over every text up to its frame count."""
    import itertools
    import torch
    import reference as ref
    lm, cls = _tiny_char_lm()
    # every frame ambiguous (several classes above the prune), the unknown
    # class never a candidate; greedy keeps a character at the last frame
    # (a blank before it), so that the search runs to the end
    logits = torch.randn(5, 5) * 1.5
    logits[:, 4] = -30.0
    logits[3, 0] = logits[4, 3] = 6.0
    logp = torch.log_softmax(logits, -1)
    lp, lb = 0.8, 0.5
    search = ref.LMSearch(lm, cls, beam=200, depth=4, prune=-20.0,
                          lm_panelty=lp, len_bonus=lb, suffix_frames=1)
    beams, = search.run([logp])

    def score(texts):
        ctc = ref.ctc_logp_many(logp, texts, cls.blank)
        lm_lp, _ = lm.score([search.tokens(t) for t in texts])
        return [c + lp * m + lb * len(t)
                for c, m, t in zip(ctc, lm_lp, texts)]
    every = [t for n in range(6) for t in itertools.product((1, 2, 3),
                                                           repeat=n)]
    every = [t for t in every
             if len(t) + sum(a == b for a, b in zip(t, t[1:])) <= 5]
    best = every[max(range(len(every)), key=score(every).__getitem__)]
    found = beams[max(range(len(beams)), key=score(beams).__getitem__)]
    assert found == best
    assert set(every) == set(beams)
