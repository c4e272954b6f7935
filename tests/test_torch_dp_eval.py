"""Data-parallel eval (``-dp N``) of the port against the JAX package's.

* ``cli/test.py -dp 2 -d cpu`` on a 16-line copy of demo/hard's test split
  (two CPU shards, one weight replica and one host thread each) against
  the JAX eval CLI's ``-dp 2`` (its 8-virtual-device mesh), both
  recognizers in f32: the same texts and CER on the greedy route, the
  plain device beam and the LM ``-ss`` route (the LM in f32, ``--lm-f32``).
  In the default bf16, ``-dp 2`` gives the port's own unsharded texts on
  every route, the host beam's included.
* The JAX driver's checks: N above the visible devices, and N that does not
  divide ``-b``, raise with its messages.
* The row-sharded LM search, mirroring ``tests/test_sharded_beam.py``: the
  search on 8 row shards equals it on the batch; ``AdaptiveLMBeam`` with 4
  shards (groups within each shard) equals it without shards and the JAX
  package's over a ``data=4`` mesh; an indivisible batch raises.
"""

import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.decode import adaptive as jad
from handwritten_chinese_ocr_samples_tpu.parallel.mesh import make_mesh
from handwritten_chinese_ocr_samples_torch.cli import test as port_cli
from handwritten_chinese_ocr_samples_torch.decode import adaptive as ad
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as bl
from handwritten_chinese_ocr_samples_torch.eval import driver as pdriver
from handwritten_chinese_ocr_samples_torch.parallel.mesh import shard_rows
from tools import convert_to_torch as conv

from tests.test_beam_skip_device import _peaky_preds
from tests.test_torch_beam_lm import setup  # noqa: F401
from tests.test_torch_eval import (  # noqa: F401
    LM, WEIGHTS, _jax_eval, _port_eval, f32_recognizers, split16)
from tests.test_torch_lm import one_torch_thread  # noqa: F401
from tests.test_torch_skip_search import AKW, BASE, _equal, _inputs

JAX_LM = conv.os.path.join(conv.DEMO, "lm")
COMMANDS = {"greedy": [], "beam": [], "lm_ss": ["--lm-f32"]}
ROUTES = dict(conv.EVAL_COMMANDS, beam=["-dm", "beam-search"])


def _argv(name, weights, data, lm, dp):
    argv = conv.eval_argv(name, weights, data, lm, commands=ROUTES)
    return argv + COMMANDS.get(name, []) + (["-dp", str(dp)] if dp else [])


@pytest.mark.parametrize("name", list(COMMANDS))
def test_dp2_eval_equals_jax_dp2(split16, f32_recognizers, name):
    want = _jax_eval(_argv(name, conv.os.path.join(conv.DEMO, "checkpoint"),
                           split16, JAX_LM, 2))
    cer, out = _port_eval(_argv(name, WEIGHTS, split16, LM, 2)
                          + ["-d", "cpu"])
    got = conv.parse_eval_output(out)
    assert len(got[0]) == 16
    assert got == want and cer == want[1]


@pytest.mark.parametrize("name", ["greedy", "lm_ss", "ngram_ss"])
def test_dp2_eval_equals_unsharded(split16, name):
    want, out = _port_eval(_argv(name, WEIGHTS, split16, LM, 0)
                           + ["-d", "cpu"])
    want_texts, _ = conv.parse_eval_output(out)
    cer, out = _port_eval(_argv(name, WEIGHTS, split16, LM, 2)
                          + ["-d", "cpu"])
    texts, _ = conv.parse_eval_output(out)
    assert len(texts) == 16 and texts == want_texts and cer == want


def test_dp_checks_raise_the_jax_messages(split16):
    args = port_cli.build_argparser().parse_args(
        ["-m", "hctr-tiny", "-f", WEIGHTS, "-i", split16, "-bm", "-b", "8",
         "-dp", "3", "-d", "cpu"])
    with pytest.raises(ValueError, match="--data-parallel 3 must divide "
                                         "the batch size 8"):
        pdriver.EvalSession(args)
    args.device, args.data_parallel = "cuda", 2
    n = torch.cuda.device_count()
    if n < 2:
        with pytest.raises(ValueError, match=f"--data-parallel 2 exceeds "
                                             f"the {n} visible devices"):
            pdriver.EvalSession(args)


# --------------------------------------------- the row-sharded LM search
def test_sharded_decode_matches_single_device(setup):  # noqa: F811
    codec, jclm, clm, (c2l, l2c) = setup
    _, targs = _inputs(_peaky_preds(T=16, B=8, seed=11))
    fn = bl.make_lm_beam_search(clm, c2l, l2c, unknown_id=codec.unknown_id,
                                use_lm_pred=True, **BASE)
    want = fn(*targs)
    parts = [fn(*(shard_rows(a, 8, i) for a in targs)) for i in range(8)]
    got = tuple(torch.cat([p[j] for p in parts]) for j in range(3))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_adaptive_with_shards_matches_single_device(setup):  # noqa: F811
    codec, jclm, clm, (c2l, l2c) = setup
    jargs, targs = _inputs(_peaky_preds(T=16, B=8, seed=12))
    kw = dict(AKW, unknown_id=codec.unknown_id, skip_search=True)
    want = ad.AdaptiveLMBeam(clm, c2l, l2c, **kw).decode(*targs)
    beam = ad.AdaptiveLMBeam(clm, c2l, l2c, shards=["cpu"] * 4, **kw)
    got = beam.decode(*targs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert beam.last_group == 2             # groups form within a shard
    jwant = jad.AdaptiveLMBeam(jclm, c2l, l2c,
                               mesh=make_mesh(data=4, model=2),
                               **kw).decode(*jargs)
    _equal((*jwant, np.zeros(8, bool)), (*got, torch.zeros(8, dtype=bool)))


def test_adaptive_shards_indivisible_batch_raises(setup):  # noqa: F811
    codec, jclm, clm, (c2l, l2c) = setup
    _, targs = _inputs(_peaky_preds(T=16, B=6, seed=13))
    beam = ad.AdaptiveLMBeam(clm, c2l, l2c, unknown_id=codec.unknown_id,
                             skip_search=True, shards=["cpu"] * 4,
                             **AKW)
    with pytest.raises(ValueError, match="not divisible"):
        beam.decode(*targs)
