"""The port's LM-fused skip search (``decode/beam_lm_device`` with
``skip_search=True``), its sizing helpers and ``AdaptiveLMBeam``'s skip
knobs, against the JAX package's, on the setup of
``tests/test_beam_skip_device.py`` and ``tests/test_adaptive_lm.py``: an f32
LM of d 32 and 2 layers (flax init, converted weights) and seeded
posteriors, K1's outputs from the JAX package's ``topk_logsoftmax_xla``.

Prefixes, lengths and overflow flags must be identical. The frame
compaction's scan sums in the JAX scan's tree order, and its values are held
to 1e-5; the schedule is integer and held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.decode import adaptive as jad
from handwritten_chinese_ocr_samples_tpu.decode import beam_lm_device as jbl
from handwritten_chinese_ocr_samples_tpu.decode.beam_device import (
    _logaddexp as jax_logaddexp)
from handwritten_chinese_ocr_samples_tpu.lm.cached import LMCache as JaxCache
from handwritten_chinese_ocr_samples_tpu.ops.topk_logsoftmax import (
    topk_logsoftmax_xla)
from handwritten_chinese_ocr_samples_tpu.utils.posteriors import (
    synth_peaky_logits as jax_synth)
from handwritten_chinese_ocr_samples_torch.decode import adaptive as ad
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as bl
from handwritten_chinese_ocr_samples_torch.lm.cached import LMCache
from handwritten_chinese_ocr_samples_torch.utils.posteriors import (
    synth_peaky_logits)

from tests.test_adaptive_lm import _soft_preds
from tests.test_beam_skip_device import _peaky_preds
from tests.test_torch_beam_lm import CHARS, _dense_char_line, setup  # noqa: F401
from tests.test_torch_lm import one_torch_thread  # noqa: F401

PRUNE = float(np.log(0.001))
BM, K = 4, 6
BASE = dict(beam_size=BM, depth=K, lm_panelty=0.7, len_bonus=1.5,
            lm_ctx=64, skip_search=True, return_overflow=True)
AKW = dict(beam_size=BM, depth=K, lm_panelty=0.7, len_bonus=1.5)


def _inputs(logits_tbd, prune=PRUNE):
    """The same (cand_vals, cand_idx, logits, logz, blank_lp, n_above) for
    both packages."""
    lg = jnp.asarray(logits_tbd.transpose(1, 0, 2))
    cv, ci, blank_lp, n_above = topk_logsoftmax_xla(lg, k=K, prune=prune)
    lz = jax.scipy.special.logsumexp(lg, axis=-1)
    jargs = (cv, ci, lg, lz, blank_lp, n_above)
    return jargs, tuple(torch.from_numpy(np.array(a)) for a in jargs)


def _equal(want, got):
    jp, jl, jo = (np.asarray(a) for a in want)
    tp, tl, to = (a.numpy() for a in got)
    np.testing.assert_array_equal(tl, jl)
    for b in range(len(jl)):
        np.testing.assert_array_equal(tp[b, :jl[b]], jp[b, :jl[b]])
    np.testing.assert_array_equal(to, jo)


_JAX_SEARCH = {}


def _jax_search(jclm, c2l, l2c, **kw):
    """The JAX package's jitted search, built once per knob set (a new
    build compiles anew)."""
    key = repr(sorted(kw.items()))
    if key not in _JAX_SEARCH:
        _JAX_SEARCH[key] = jbl.make_lm_beam_search(jclm, c2l, l2c, **kw)
    return _JAX_SEARCH[key]


def _both(setup, logits_tbd, prune=PRUNE, **kw):
    codec, jclm, clm, (c2l, l2c) = setup
    jargs, targs = _inputs(logits_tbd, prune)
    kw = dict(BASE, unknown_id=codec.unknown_id, prune=prune, **kw)
    want = _jax_search(jclm, c2l, l2c, **kw)(*jargs)
    got = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs)
    _equal(want, got)
    return got


# ------------------------------------------------------------ the search
@pytest.mark.parametrize("prune_p", [0.001, 0.05])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("use_pred", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_skip_search_matches_jax(setup, seed, use_pred, group, prune_p):
    """Peaky posteriors at the reference prune, soft runner-ups (ambiguous
    at 0.001, char-fast at 0.05) at the calibrated one."""
    lt = (_peaky_preds(T=24, B=4, seed=seed) if prune_p == 0.001
          else _soft_preds(T=20, B=4, seed=seed))
    got = _both(setup, lt, prune=float(np.log(prune_p)),
                use_lm_pred=use_pred, group_size=group)
    assert got[0].dtype == torch.int32 and not bool(got[2].any())
    assert int(got[1].min()) > 0


def _knobs(name, ci, n_above, unknown_id):
    kept = int(bl.count_kept_frames(ci, n_above,
                                    unknown_id=unknown_id).max())
    segs = int(bl.count_segments(ci, n_above, unknown_id=unknown_id).max())
    pr = bl.count_peek_rows(n_above, depth=K)
    ladder = [c for c in (8, 12, 16, 24, 32) if bl.count_ladder_segments(
        ci, n_above, ctx1=c, unknown_id=unknown_id) >= 1][0]
    k1 = bl.count_ladder_segments(ci, n_above, ctx1=ladder,
                                  unknown_id=unknown_id)
    k2 = bl.count_ladder_segments(ci, n_above, ctx1=2 * ladder,
                                  unknown_id=unknown_id)
    assert pr < 2 * K and kept < 32 and 1 <= k1 < segs
    return {
        "kept_budget": dict(kept_budget=kept),
        "kept_budget_cut": dict(kept_budget=kept - 3),
        "seg_budget_run_max_2": dict(seg_budget=int(bl.count_segments(
            ci, n_above, unknown_id=unknown_id, run_max=2).max()),
            run_max=2),
        "run_max_1": dict(run_max=1),
        "seg_budget_cut": dict(seg_budget=3),
        "peek_rows": dict(peek_rows=pr),
        "peek_rows_grouped": dict(peek_rows=pr, group_size=2),
        "peek_rows_undersized": dict(peek_rows=1),
        "ladder": dict(seg_budget=segs + 1, ctx_ladder=(k1, ladder)),
        "ladder_grouped": dict(seg_budget=segs + 1, group_size=2,
                               ctx_ladder=(1, ladder)),
        "ladder_two_rungs": dict(seg_budget=segs + 1, ctx_ladder=[
            (k1, ladder), (max(min(k2, segs), k1 + 1), 2 * ladder)]),
        "ladder_unsound": dict(seg_budget=segs + 1, ctx_ladder=(segs, 2)),
        "fused_commit": dict(fused_commit=True),
        "fused_commit_grouped": dict(fused_commit=True, group_size=2),
        "fused_commit_ladder": dict(fused_commit=True, ctx_ladder=(2, 16)),
        "fused_commit_peek_rows": dict(fused_commit=True, peek_rows=pr,
                                       group_size=4),
    }[name]


@pytest.mark.parametrize("name", [
    "kept_budget", "kept_budget_cut", "seg_budget_run_max_2", "run_max_1",
    "seg_budget_cut", "peek_rows", "peek_rows_grouped",
    "peek_rows_undersized", "ladder", "ladder_grouped", "ladder_two_rungs",
    "ladder_unsound", "fused_commit", "fused_commit_grouped",
    "fused_commit_ladder", "fused_commit_peek_rows"])
def test_skip_knobs_match_jax(setup, name):
    """Budgets (sufficient and cutting), peek-row compaction (exact and
    undersized, which must raise the flag), the context ladder (sound, two
    rungs, unsound: flagged) and the fused commit, on the same data."""
    codec = setup[0]
    lt = _peaky_preds(T=32, B=4, seed=21)
    _, (_, ci, _, _, _, n_above) = _inputs(lt)
    got = _both(setup, lt, **_knobs(name, ci, n_above, codec.unknown_id))
    # sound knobs raise no flag; the undersized ones must; rungs that are
    # not sized from the bound may go either way (equal to JAX above)
    flagged = {"peek_rows_undersized": True, "ladder_unsound": True,
               "ladder_two_rungs": None,
               "fused_commit_ladder": None}.get(name, False)
    if flagged is not None:
        assert bool(got[2].any()) is flagged


@pytest.mark.parametrize("fused", [False, True])
def test_run_before_ambiguous_frame_matches_jax(setup, fused):
    """A confident character run right before an ambiguous frame, so the
    fused commit's deferred run k/v are attended by the peek."""
    D = len(CHARS) + 2
    rng = np.random.default_rng(3)
    lt = rng.normal(size=(24, 1, D)).astype(np.float32) * 0.2
    lt[:, 0, 0] += 12.0
    for i, t in enumerate((4, 6, 8, 10)):
        lt[t, 0, 0] -= 12.0
        lt[t, 0, 1 + i] += 12.0
    lt[12, 0, 0] -= 12.0
    lt[12, 0, 5] += 11.3
    lt[12, 0, 6] += 11.0
    got = _both(setup, lt, fused_commit=fused)
    assert setup[0].compact_to_texts(got[0].numpy(), got[1].numpy())[0]


@pytest.mark.parametrize("peek_rows", [2 * K, 3])
def test_full_search_peek_rows_match_jax(setup, peek_rows):
    """The full search takes ``peek_rows`` too: a no-op at depth + lm_depth,
    and below it the overflow flag as in the JAX package (its no-op frames
    past the batch's last active frame included)."""
    codec, jclm, clm, (c2l, l2c) = setup
    jargs, targs = _inputs(_peaky_preds(T=16, B=2, seed=5))
    kw = dict(BASE, unknown_id=codec.unknown_id, skip_search=False,
              peek_rows=peek_rows)
    want = jbl.make_lm_beam_search(jclm, c2l, l2c, **kw)(*jargs[:4])
    got = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs[:4])
    _equal(want, got)
    assert bool(got[2].any()) is (peek_rows < 2 * K)


def test_build_errors_match_jax(setup):
    codec, jclm, clm, (c2l, l2c) = setup
    kw = dict(AKW, unknown_id=codec.unknown_id, lm_ctx=64)
    for extra, err in (
            (dict(skip_search=True, peek_rows=3), "return_overflow"),
            (dict(skip_search=True, ctx_ladder=(2, 64)), "ctx_ladder"),
            (dict(skip_search=True, ctx_ladder=[(4, 16), (2, 32)]),
             "ctx_ladder"),
            (dict(skip_search=False, ctx_ladder=(2, 8)), "skip_search"),
            (dict(skip_search=False, fused_commit=True), "fused_commit")):
        for mod, c in ((jbl, jclm), (bl, clm)):
            with pytest.raises(ValueError, match=err):
                mod.make_lm_beam_search(c, c2l, l2c, **kw, **extra)
    _, targs = _inputs(_peaky_preds(T=8, B=1, seed=0))
    with pytest.raises(ValueError, match="n_above"):
        bl.make_lm_beam_search(clm, c2l, l2c, **kw, skip_search=True)(
            *targs[:4])


# ------------------------------------------------------------- the peek
@pytest.mark.parametrize("mode", ["want_last", "extra_kv", "full_kv"])
def test_grouped_peek_modes_match_jax(setup, mode):
    """The run phase's peek (``full_kv`` + ``want_last``) and the fused
    commit's (``extra_kv`` at shifted positions) against the JAX package's
    ``_grouped_peek`` on one random cache, f32."""
    _, jclm, clm, _ = setup
    rng = np.random.default_rng(7)
    NB, R, S1, L, E = 6, 3, 5, 16, 4
    H, Dh = clm.n_heads, clm.d_head
    shape = (clm.n_layers, NB, L, H, Dh)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 1, 5, 9, 11, 12], np.int32)
    V = clm.emb.shape[0]
    tokens = rng.integers(4, V, (NB, R, S1)).astype(np.int32)
    n_tok = rng.integers(0, S1 + 1, (NB, R)).astype(np.int32)
    nlp = np.log(rng.dirichlet(np.ones(V), NB)).astype(np.float32)
    kw = {"want_last": dict(full_kv=True, want_last=True),
          "full_kv": dict(full_kv=True), "extra_kv": {}}[mode]
    jx = dict(kw)
    tx = dict(kw)
    if mode == "extra_kv":
        ek, ev = (rng.normal(size=(clm.n_layers, NB, E, H, Dh))
                  .astype(np.float32) for _ in range(2))
        en = np.array([0, 4, 2, 1, 3, 0], np.int32)
        jx.update(extra_kv=(jnp.asarray(ek), jnp.asarray(ev),
                            jnp.asarray(en)), pos_offset=jnp.asarray(en))
        tx.update(extra_kv=(torch.from_numpy(ek), torch.from_numpy(ev),
                            torch.from_numpy(en)),
                  pos_offset=torch.from_numpy(en))
    want = jbl._grouped_peek(
        jclm, JaxCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)),
        jnp.asarray(tokens), jnp.asarray(n_tok), jnp.asarray(nlp), **jx)
    got = bl._grouped_peek(
        clm, LMCache(torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(lengths)),
        torch.from_numpy(tokens), torch.from_numpy(n_tok),
        torch.from_numpy(nlp), **tx)
    assert len(got) == len(want) == (5 if mode == "want_last" else 4)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# ----------------------------------------------- compaction and schedule
def _jax_comb(x, y):
    """``decode_one``'s ``comb`` (JAX package, ``beam_lm_device.py``)."""
    fx, ax, bx = x
    fy, ay, by = y
    a = ay + ax
    b = jax_logaddexp(ay + bx, by)
    return fx | fy, jnp.where(fy, ay, a), jnp.where(fy, by, b)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 1200])
def test_blank_run_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    kept = rng.random((3, T)) < 0.2
    blank = ~kept & (rng.random((3, T)) < 0.8)
    p = -rng.exponential(0.01, (3, T)).astype(np.float32)
    op_a = np.where(blank, p, 0.0).astype(np.float32)
    op_b = np.where(blank, p, -1e30).astype(np.float32)
    want = jax.jit(jax.vmap(
        lambda *e: jax.lax.associative_scan(_jax_comb, e)[1:]))(
        jnp.asarray(kept), jnp.asarray(op_a), jnp.asarray(op_b))
    got = bl.blank_run_scan(torch.from_numpy(kept), torch.from_numpy(op_a),
                            torch.from_numpy(op_b))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _jax_schedule(charfast, amb, budget, SB, RM):
    """``decode_one``'s kept-frame order and ``sched`` scan (JAX package,
    ``beam_lm_device.py:933-970``) for one line."""
    T = charfast.shape[0]
    kept = charfast | amb
    t_ids = jnp.arange(T)
    order = jnp.argsort(jnp.where(kept, t_ids, T + t_ids))
    kept_ts = order[:budget]
    act = jnp.arange(budget) < jnp.sum(kept)
    is_cf = charfast[kept_ts] & act
    is_amb = act & ~is_cf

    def sched(carry, xs):
        seg, pos, cf_map, amb_map = carry
        t, cf, am = xs
        overflow = cf & (pos >= RM)
        w_seg = jnp.where(overflow, seg + 1, seg)
        w_pos = jnp.where(overflow, 0, pos)
        cf_map = cf_map.at[jnp.where(cf, w_seg, SB), w_pos].set(
            t, mode="drop")
        amb_map = amb_map.at[jnp.where(am, w_seg, SB)].set(t, mode="drop")
        seg = jnp.where(am, w_seg + 1, w_seg)
        pos = jnp.where(am, 0, jnp.where(cf, w_pos + 1, pos))
        return (seg, pos, cf_map, amb_map), ()

    (_, _, cf_map, amb_map), _ = jax.lax.scan(
        sched, (jnp.int32(0), jnp.int32(0),
                jnp.full((SB, RM), -1, jnp.int32),
                jnp.full((SB,), -1, jnp.int32)),
        (kept_ts.astype(jnp.int32), is_cf, is_amb))
    return np.asarray(cf_map), np.asarray(amb_map)


@pytest.mark.parametrize("seed", range(4))
def test_segment_schedule_matches_jax(seed):
    """``cf_map``/``amb_map`` built in closed form equal the JAX package's
    sequential scan, exactly, with and without budgets that cut."""
    rng = np.random.default_rng(seed)
    B, T = 3, int(rng.integers(8, 80))
    amb = rng.random((B, T)) < 0.15
    charfast = ~amb & (rng.random((B, T)) < 0.5)
    charfast[0] = amb[0] = False                   # an empty line
    if seed == 1:
        amb[1], charfast[1] = True, False          # every frame ambiguous
    for RM in (1, 2, 8):
        for budget, SB in ((T, T), (T // 3, T), (T, 4)):
            cf_map, amb_map = bl.segment_schedule(
                torch.from_numpy(charfast), torch.from_numpy(amb), budget,
                min(SB, budget), RM)
            for b in range(B):
                wc, wa = _jax_schedule(jnp.asarray(charfast[b]),
                                       jnp.asarray(amb[b]), budget,
                                       min(SB, budget), RM)
                np.testing.assert_array_equal(cf_map[b].numpy(), wc)
                np.testing.assert_array_equal(amb_map[b].numpy(), wa)


def _random_batch(rng, trial, B, T):
    D, unknown_id = 8, 7
    arg = rng.integers(0, D, (B, T))
    if trial == 0:
        arg[0] = 0                                 # empty line: all blank
    n_above = np.where(rng.random((B, T)) < 0.7, 1,
                       rng.integers(2, 5, (B, T))).astype(np.int32)
    if trial == 1:
        n_above[:] = 3                             # every frame ambiguous
    ci = np.zeros((B, T, 3), np.int32)
    ci[:, :, 0] = arg
    return ci, n_above, unknown_id, 1 + trial % 4


# (B, T) of the random batches: the JAX side compiles once per shape
SHAPES = [(1, 5), (3, 37), (4, 59)]


@pytest.mark.parametrize("B,T", SHAPES)
def test_host_counts_match_jax(B, T):
    rng = np.random.default_rng(T)
    for trial in range(10):
        ci, na, unk, rm = _random_batch(rng, trial, B, T)
        np.testing.assert_array_equal(
            bl.count_kept_frames(ci, na, unknown_id=unk),
            jbl.count_kept_frames(ci, na, unknown_id=unk))
        np.testing.assert_array_equal(
            bl.count_segments(torch.from_numpy(ci), torch.from_numpy(na),
                              unknown_id=unk, run_max=rm),
            jbl.count_segments(ci, na, unknown_id=unk, run_max=rm))
        for ctx1 in (2, 4, 8, 1000):
            assert bl.count_ladder_segments(
                ci, na, ctx1=ctx1, unknown_id=unk, run_max=rm) == \
                jbl.count_ladder_segments(ci, na, ctx1=ctx1, unknown_id=unk,
                                          run_max=rm)
        for use_pred in (False, True):
            assert bl.count_peek_rows(na, depth=3, use_lm_pred=use_pred) \
                == jbl.count_peek_rows(na, depth=3, use_lm_pred=use_pred)


@pytest.mark.parametrize("B,T", SHAPES)
def test_device_counts_match_jax(B, T):
    """``make_count_stats`` (also with ``n_above=None``), ``make_count_ladder``
    and ``make_count_sizing`` equal the JAX package's jitted ones."""
    rng = np.random.default_rng(10 + T)
    jfns = {}
    for trial in range(8):
        ci, na, unk, rm = _random_batch(rng, trial, B, T)
        kw = dict(unknown_id=unk, run_max=rm)
        if rm not in jfns:
            jfns[rm] = (jbl.make_count_stats(**kw),
                        jbl.make_count_ladder(**kw),
                        jbl.make_count_sizing(**kw))
        jstats, jladder, jsizing = jfns[rm]
        jci, jna = jnp.asarray(ci), jnp.asarray(na)
        tci, tna = torch.from_numpy(ci), torch.from_numpy(na)
        assert bl.make_count_stats(**kw)(tci, tna).tolist() == \
            [int(x) for x in jstats(jci, jna)]
        assert bl.make_count_stats(**kw)(tci, None).tolist()[:2] == \
            [int(x) for x in jstats(jci, None)][:2]
        for ctx1 in (2, 4, 8, 1000):
            assert int(bl.make_count_ladder(**kw)(tci, tna, ctx1)) == \
                int(jladder(jci, jna, ctx1))
            assert bl.make_count_sizing(**kw)(tci, tna, ctx1).tolist() == \
                [int(x) for x in jsizing(jci, jna, ctx1)]


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_peaky_logits_bit_equal(seed):
    got = synth_peaky_logits(2, 240, 50, seed=seed)
    want = jax_synth(2, 240, 50, seed=seed)
    assert got.dtype == np.float32 and got.shape == (2, 240, 50)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- AdaptiveLMBeam
def _beams(setup, **kw):
    codec, jclm, clm, (c2l, l2c) = setup
    kw = dict(AKW, unknown_id=codec.unknown_id, **kw)
    return (jad.AdaptiveLMBeam(jclm, c2l, l2c, **kw),
            ad.AdaptiveLMBeam(clm, c2l, l2c, **kw))


def _sized_like_jax(jbeam, beam):
    assert (beam._ctx, beam._budget, beam._peek, beam._ladder_k) == \
        (jbeam._ctx, jbeam._budget, jbeam._peek, jbeam._ladder_k)


def test_adaptive_default_is_skip_search(setup):
    jbeam, beam = _beams(setup)
    assert beam.skip and jbeam.skip
    jargs, targs = _inputs(_peaky_preds(T=16, B=4, seed=3))
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    _equal((*want, np.zeros(4, bool)), (*got, torch.zeros(4, dtype=bool)))
    _sized_like_jax(jbeam, beam)
    assert beam._peek > 0 and beam._budget >= 16 and beam.last_group == 4
    direct = beam.search(beam.last_group)(*targs)
    assert all(torch.equal(a, b) for a, b in zip(got, direct[:2]))


@pytest.mark.parametrize("ladder", [16, 0, 4096])
def test_adaptive_ladder_matches_jax(setup, ladder):
    """A dense line: the ladder engages at 16 positions, is off at 0, and
    quietly off at a rung above the chosen context."""
    jbeam, beam = _beams(setup, run_max=1, ctx_ladder=ladder)
    jargs, targs = _inputs(_dense_char_line(160, 40, seed=9))
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    _equal((*want, np.zeros(1, bool)), (*got, torch.zeros(1, dtype=bool)))
    _sized_like_jax(jbeam, beam)
    assert (beam._ladder_k >= 8) is (ladder == 16)


@pytest.mark.parametrize("prune_p", [0.001, 0.05])
def test_adaptive_prune_matches_jax(setup, prune_p):
    prune = float(np.log(prune_p))
    jbeam, beam = _beams(setup, prune=prune)
    jargs, targs = _inputs(_soft_preds(T=20, B=4, seed=3), prune)
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    _equal((*want, np.zeros(4, bool)), (*got, torch.zeros(4, dtype=bool)))
    _sized_like_jax(jbeam, beam)


def test_adaptive_skip_escalates_like_jax(setup, monkeypatch):
    for mod in (jad, ad):
        monkeypatch.setattr(mod, "STABLE_CTX", (12, 64))
        monkeypatch.setattr(mod, "CTX_MARGIN", 0)
    jbeam, beam = _beams(setup)
    jargs, targs = _inputs(_dense_char_line(40, 12, seed=5))
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    assert beam._ctx == jbeam._ctx == 64
    _equal((*want, np.zeros(1, bool)), (*got, torch.zeros(1, dtype=bool)))


def test_adaptive_skip_pinned_errors(setup):
    codec, _, clm, (c2l, l2c) = setup
    kw = dict(AKW, unknown_id=codec.unknown_id)
    _, targs = _inputs(_dense_char_line(40, 12, seed=2))
    with pytest.raises(RuntimeError, match="lm-ctx"):
        ad.AdaptiveLMBeam(clm, c2l, l2c, lm_ctx=8, **kw).decode(*targs)
    _, targs = _inputs(_peaky_preds(T=16, B=2, seed=1))
    with pytest.raises(RuntimeError, match="seg-budget"):
        ad.AdaptiveLMBeam(clm, c2l, l2c, seg_budget=1, **kw).decode(*targs)
    with pytest.raises(ValueError, match="ctx_ladder"):
        ad.AdaptiveLMBeam(clm, c2l, l2c, ctx_ladder=-1, **kw)
