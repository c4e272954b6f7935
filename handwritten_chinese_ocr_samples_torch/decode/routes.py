"""Decode routes, shared by the serving engine and the eval driver.

``build_route`` picks one of four routes for a decode configuration and
builds its decoder once; ``DecodeRoute.dispatch(logits)`` queues the route's
device work and returns ``finalize() -> texts``, which runs its host tail
(the D2H, the host search, the string join). The routes, as the JAX serving
engine picks them (its ``serve/engine.py:138-147``):

  * ``greedy``: argmax + CTC collapse on the device (``ops/decode``);
  * ``beam``: a beam search without an LM, the fused log-softmax + top-K
    (kernel K1) feeding the device prefix beam search
    (``decode/beam_device``), with the merge of ``HCTR_DENSE_MERGE``
    (``dense_merge_default``, read when the route is built, as the JAX
    engine and driver read it);
  * ``lm``: a beam search scored by a transformer LM (one with
    ``lm_model``), K1 with its blank log-prob and its count of classes above
    ``prune`` and the frame log-partition feeding the LM-fused device search
    (``decode/adaptive`` over ``decode/beam_lm_device``, kernels K2-K4): the
    skip search with ``skip_search``, else the full per-frame search;
  * ``host``: the other beam configurations that skip frames or consult an
    LM (an n-gram ``KenLMBackend``, or a transformer's proposals without its
    scores), and every beam search with ``host_beam``: an f32 log-softmax on
    the device, the posteriors to the host once a batch, and the host beam
    search there, native (``decode/beam_host_native``) where the
    configuration qualifies, else the Python one (``decode/beam_host``).

An LM that is neither scored nor proposing is ignored. The D2H goes to
pinned memory behind an event (``to_host``), so that work queued after a
dispatch does not hold it back.

Spans (``utils/profiling``, off unless enabled): ``route.dispatch`` around
the queueing, ``route.finalize`` around the host tail, and in it
``route.d2h_wait`` (the wait on ``to_host``'s event) and ``route.texts``
(the index rows to strings).

``dispatch_shards`` decodes a batch's row shards (``-dp``), each shard's
logits on its own device: the ``lm`` route through ``AdaptiveLMBeam``'s
shards (built with ``shards=``), the others shard by shard, with each
shard's host tail on its own thread.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from ..ops import topk_logsoftmax as _k1
from ..ops.decode import greedy_decode_device
from ..parallel.mesh import on_shard
from ..utils.profiling import span
from .beam_device import beam_search_fused, dense_merge_default


def to_host(*tensors: torch.Tensor) -> Callable[[], List[np.ndarray]]:
    """Start the D2H of ``tensors`` behind the work queued so far; returns
    ``wait() -> numpy arrays``. On the card the copies go to pinned memory
    and ``wait`` blocks on an event; on the CPU they are the arrays."""
    if tensors[0].device.type != "cuda":
        arrays = [t.numpy() for t in tensors]
        return lambda: arrays
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        with span("route.d2h_wait"):
            done.synchronize()
        return [h.numpy() for h in hosts]
    return wait


class DecodeRoute:
    """One configuration's decode: ``name`` (``greedy``, ``beam``, ``lm`` or
    ``host``), and ``host`` (the host decoder) or ``lm_beam``
    (``decode/adaptive.AdaptiveLMBeam``) where the route has one."""

    def __init__(self, name: str, codec, beam_size: int, search_depth: int,
                 len_bonus: float, prune_lp: float, host=None, lm_beam=None,
                 dense_merge: bool = True):
        self.name = name
        self.dense_merge = dense_merge
        self.codec = codec
        self.beam_size = beam_size
        self.search_depth = search_depth
        self.len_bonus = len_bonus
        self.prune_lp = prune_lp
        self.host = host
        self.lm_beam = lm_beam

    @property
    def decoder(self) -> str:
        """The decoder that serves this route, for logs."""
        if self.host is not None:
            return type(self.host).__name__
        return {"greedy": "greedy (device)", "beam": "beam (device, K1)",
                "lm": "LM-fused beam (device, K1-K4)"}[self.name]

    def dispatch(self, logits: torch.Tensor) -> Callable[[], List[str]]:
        """Queue the device work of a ``(B, T, D)`` logits batch; returns
        ``finalize() -> B texts``."""
        with span("route.dispatch"):
            finalize = self._queue(logits)

        def traced_finalize():
            with span("route.finalize"):
                return finalize()
        return traced_finalize

    def _queue(self, logits: torch.Tensor) -> Callable[[], List[str]]:
        codec = self.codec
        if self.name == "lm":
            cv, ci, blank_lp, n_above = self.lm_inputs(logits)
            logz = torch.logsumexp(logits.float(), dim=-1)

            def finalize():
                with torch.inference_mode():
                    chars, lengths = self.lm_beam.decode(
                        cv, ci, logits, logz, blank_lp, n_above)
                with span("route.texts"):
                    return codec.compact_to_texts(chars.cpu().numpy(),
                                                  lengths.cpu().numpy())
            return finalize
        if self.name == "host":
            wait_logp = to_host(torch.log_softmax(logits.float(), dim=-1))

            def finalize():
                logp, = wait_logp()
                with torch.inference_mode():   # LM proposals on the device
                    return self.host.decode(logp.transpose(1, 0, 2),
                                            already_log=True)
            return finalize
        if self.name == "beam":
            wait = to_host(*beam_search_fused(
                logits, beam_size=self.beam_size, depth=self.search_depth,
                unknown_id=codec.unknown_id, blank_id=codec.blank_id,
                len_bonus=self.len_bonus, dense_merge=self.dense_merge))
        else:
            wait = to_host(*greedy_decode_device(
                logits, unknown_id=codec.unknown_id,
                blank_id=codec.blank_id))

        def finalize():
            chars, lengths = wait()
            with span("route.texts"):
                return codec.compact_to_texts(chars, lengths)
        return finalize

    def lm_inputs(self, logits: torch.Tensor):
        """K1 at the route's depth and prune: ``(cand_vals, cand_idx,
        blank_lp, n_above)``."""
        return _k1.topk_logsoftmax(logits, k=self.search_depth,
                                   prune=self.prune_lp)

    def dispatch_shards(self, logits: List[torch.Tensor], pool
                        ) -> Callable[[], List[str]]:
        """``dispatch`` of a batch's row shards (``logits[i]`` on shard
        ``i``'s device), each shard's device work and host tail on
        ``pool``'s threads; returns ``finalize() -> texts`` in row order."""
        codec = self.codec
        n = len(logits)

        def on(i, fn, *args):           # shard i's work, on its thread
            with on_shard(i, logits[i].device), torch.inference_mode():
                return fn(*args)

        if self.name != "lm":
            finals = list(pool.map(on, range(n), [self.dispatch] * n,
                                   logits))

            def finalize():
                return [t for texts in pool.map(on, range(n), finals)
                        for t in texts]
            return finalize

        def prep(x):
            cv, ci, blank_lp, n_above = self.lm_inputs(x)
            return (cv, ci, x, torch.logsumexp(x.float(), dim=-1), blank_lp,
                    n_above)
        parts = list(pool.map(on, range(n), [prep] * n, logits))

        def finalize():
            texts = []
            for chars, lengths in self.lm_beam.decode_shards(parts):
                texts += codec.compact_to_texts(chars.cpu().numpy(),
                                                lengths.cpu().numpy())
            return texts
        return finalize


def build_route(codec, decode_method: str = "greedy-search", lm=None, *,
                use_lm_pred: bool = False, use_lm_score: bool = False,
                skip_search: bool = False, host_beam: bool = False,
                beam_size: int = 10, search_depth: int = 10,
                lm_panelty: float = 1.9, len_bonus: float = 5.7,
                prune: float = 0.001, lm_f32: bool = False,
                lm_int8: bool = False, lm_group: int = 8, lm_ctx: int = 0,
                seg_budget: int = 0, run_max: int = 8, ctx_ladder: int = 112,
                fused_commit: bool = False,
                device: str | torch.device = "cuda",
                shards=None) -> DecodeRoute:
    """The route of a configuration, with its decoder built. ``lm`` is a
    ``decode/lm_interface`` backend or None; a transformer LM's proposals
    run on ``device``. ``prune`` is the skip search's ambiguity threshold, a
    probability; ``lm_group`` to ``fused_commit`` are
    ``decode/adaptive.AdaptiveLMBeam``'s, the LM in bf16 unless ``lm_f32``,
    its step's FF and logits products in int8 with ``lm_int8`` (the device
    search's LM only; other routes ignore it, as in the JAX engine).
    ``shards``: the devices of ``-dp``'s row shards, for the ``lm`` route's
    search (one LM replica each). A native library that does not build
    raises."""
    if decode_method not in ("greedy-search", "beam-search"):
        raise ValueError(f"unknown decode method {decode_method!r}")
    is_tfm = lm is not None and hasattr(lm, "lm_model")
    prune_lp = math.log(prune)
    kw = dict(codec=codec, beam_size=beam_size, search_depth=search_depth,
              len_bonus=len_bonus, prune_lp=prune_lp,
              dense_merge=dense_merge_default())
    if decode_method == "greedy-search":
        return DecodeRoute("greedy", **kw)
    if use_lm_score and is_tfm and not host_beam:
        from ..lm.cached import CachedLM
        from .adaptive import AdaptiveLMBeam
        from .beam_lm_device import make_id_tables
        clm = CachedLM(lm.lm_model, lm.lm_params,
                       dtype=torch.float32 if lm_f32 else torch.bfloat16,
                       quant_int8=lm_int8, device=device)
        c2l, l2c = make_id_tables(codec, lm.tokenizer)
        return DecodeRoute("lm", **kw, lm_beam=AdaptiveLMBeam(
            clm, c2l, l2c, beam_size=beam_size, depth=search_depth,
            unknown_id=codec.unknown_id, lm_panelty=lm_panelty,
            len_bonus=len_bonus, use_lm_pred=use_lm_pred,
            skip_search=skip_search, group_size=lm_group, lm_ctx=lm_ctx,
            seg_budget=seg_budget, run_max=run_max, ctx_ladder=ctx_ladder,
            fused_commit=fused_commit, prune=prune_lp, shards=shards))
    if not (host_beam or skip_search or use_lm_score
            or (use_lm_pred and lm is not None)):
        return DecodeRoute("beam", **kw)
    from .beam_host import BeamSearchConfig, BeamSearchDecoder
    from .beam_host_native import try_native_host_decoder
    from .lm_interface import NullLM
    cfg = BeamSearchConfig(
        beam_size=beam_size, search_depth=search_depth,
        lm_panelty=lm_panelty, len_bonus=len_bonus,
        use_lm_pred=use_lm_pred and lm is not None,
        use_lm_score=use_lm_score and lm is not None,
        skip_search=skip_search, prune_log_prob=prune_lp)
    if is_tfm:
        lm.to(device)                    # LM proposals run on the device
    host = (try_native_host_decoder(codec, cfg, lm=lm)
            or BeamSearchDecoder(codec, lm or NullLM(), cfg))
    return DecodeRoute("host", **kw, host=host)
