"""LM plug-in: the char transformer (the port's ``lm/model.py``
``CharTransformerLM``, served through ``decode/lm_interface.py``
``TorchLMBackend``), a pre-norm decoder with learned positions, LayerNorm
and a tied head; the fusion LM of ``hctr-bf16``.

An LM plug-in is the one file that knows its architecture. The harness
finds it by the configuration's ``lm.arch`` (``lms/<arch>.py``; this file
where it names none) and calls nothing else LM-specific:

  * ``load_state(lm_cfg, device)``: the state dict that both the program
    and the reference get;
  * ``program_lm(lm_cfg, state, device)``: the port's LM for
    ``ServingEngine(lm=...)``; the port is imported inside it (and inside
    ``program_logprobs``) alone;
  * ``reference_lm(lm_cfg, state, device)``: the plain reference LM, with
    ``reference.LMSearch``'s interface (``index``, ``tokens(text)``,
    ``score(texts)``);
  * ``token_flops(lm_cfg, context)``: the matrix FLOPs of one token at
    ``context`` cached positions, for ``mfu`` readers;
  * ``bounds``: kernel bounds (``name -> function`` giving ``(ms, bound
    by)``, as ``roofline.bound_ms``) of kernels that only this LM runs;
  * optionally ``program_logprobs(engine, rows)``: the program's own LM
    log-probs over token rows, through the LM that the engine's LM route
    holds and the search's own paths, for the check's ``lm_gap``; a
    plug-in without it leaves ``lm_gap`` out.

``lm_cfg`` is the configuration's ``lm`` block; its ``weights`` names a
state dict's file, or gives ``{"seed": n}`` to draw the weights on the
device (``assets.seeded_state``) at the widths of its ``config``.
"""

from __future__ import annotations

import math

import torch

import assets
import reference as ref
import roofline

bounds: dict = {}


def specs(cfg: dict) -> dict:
    """``name -> (shape, init)`` of the state dict at ``cfg``'s widths,
    after the port's seeded LM (``utils/weights.seeded_lm_state_dict``):
    matrices ~ N(0, 1/fan_in), the embedding ~ N(0, 1/d), positions ~
    N(0, 0.02^2), biases 0, LayerNorms at identity."""
    d, ff, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    out = {"embed.weight": ((V, d), 1 / math.sqrt(d)),
           "pos_embed": ((cfg["max_len"], d), 0.02)}

    def dense(name, n_out, n_in):
        out[f"{name}.weight"] = ((n_out, n_in), 1 / math.sqrt(n_in))
        out[f"{name}.bias"] = ((n_out,), "zeros")

    def norm(name):
        out[f"{name}.weight"] = ((d,), "ones")
        out[f"{name}.bias"] = ((d,), "zeros")

    for i in range(cfg["n_layers"]):
        p = f"layer{i}"
        norm(f"{p}.ln1")
        for n in ("query", "key", "value", "out"):
            dense(f"{p}.attn.{n}", d, d)
        norm(f"{p}.ln2")
        dense(f"{p}.ff1", ff, d)
        dense(f"{p}.ff2", d, ff)
    norm("ln_f")
    return out


def load_state(lm_cfg: dict, device) -> dict:
    """A file's state dict in f32 on the host, or one drawn from the seed
    on ``device`` in the LM's serving dtype."""
    weights = lm_cfg["weights"]
    if isinstance(weights, dict):
        return assets.seeded_state(specs(lm_cfg["config"]), weights["seed"],
                                   device, getattr(torch, lm_cfg["dtype"]))
    return assets.load_state(weights)


def program_lm(lm_cfg: dict, state: dict, device):
    from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
        TorchLMBackend)
    from handwritten_chinese_ocr_samples_torch.lm.model import (
        CharTransformerLM)
    from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
    return TorchLMBackend(CharTransformerLM(**lm_cfg["config"]), state,
                          Tokenizer(assets.repo_path(lm_cfg["dict"])),
                          device=device)


def program_logprobs(engine, rows):
    """The LM of ``engine``'s LM route (its ``CachedLM``: the timed path's
    object, weights, dtype and kernels) over ``rows``, ``(prefix,
    continuation)`` token lists whose prefix starts with ``<s>``, as the
    skip search reads it: each prefix committed into a KV cache as the
    search commits an extension (``<s>`` by the LM's step, then each token's
    k/v from a one-token peek written by ``gather_write``, kernel K4), then
    each continuation scored by one grouped peek (kernels K2 and K3), the
    rows laid out as the search's group of ``lm_group`` x ``beam_size``
    beams. Returns the next-token log-probs after each prefix ``(n, V)``
    and each continuation's summed log-prob after it ``(n,)``."""
    from handwritten_chinese_ocr_samples_torch.decode.beam_lm_device import (
        _grouped_peek)
    from handwritten_chinese_ocr_samples_torch.lm.cached import CachedLM
    search = engine.route.lm_beam
    clm = search._clm
    nb = search.group_size * search._kw["beam_size"]
    dev = clm.device
    nexts, sums = [], []
    with torch.inference_mode():
        for s in range(0, len(rows), nb):
            part = rows[s:s + nb]
            part = part + [part[-1]] * (nb - len(part))
            pre = [p[1:] for p, _ in part]
            n_pre = max(len(p) for p in pre)
            depth = max(search._ctx, n_pre + 1)
            cache = clm.init_cache(nb, depth)
            logits, cache = clm.step(cache, torch.zeros(
                (nb,), dtype=torch.long, device=dev))
            next_logp = torch.log_softmax(logits, dim=-1)
            every = torch.arange(nb, dtype=torch.int32, device=dev)
            for j in range(n_pre):
                tok = torch.tensor([p[j] if j < len(p) else 0 for p in pre],
                                   dtype=torch.long, device=dev)
                on = torch.tensor([j < len(p) for p in pre], device=dev)
                _, logp0, k0, v0 = _grouped_peek(
                    clm, cache, tok.view(nb, 1, 1), on.view(nb, 1).int(),
                    next_logp)
                glen = cache.lengths
                cache = CachedLM.gather_write(
                    cache, every, k0[:, :, 0].to(clm.dtype),
                    v0[:, :, 0].to(clm.dtype),
                    torch.where(on, glen, depth).to(torch.int32))._replace(
                        lengths=torch.where(on, glen + 1, glen))
                next_logp = torch.where(on[:, None], logp0[:, 0], next_logp)
            n_cont = max(1, max(len(c) for _, c in part))
            cont = torch.tensor([c + [0] * (n_cont - len(c))
                                 for _, c in part], dtype=torch.long,
                                device=dev)
            lens = torch.tensor([len(c) for _, c in part], device=dev)
            total = _grouped_peek(clm, cache, cont.view(nb, 1, n_cont),
                                  lens.view(nb, 1), next_logp)[0]
            k = min(nb, len(rows) - s)
            nexts.append(next_logp[:k].float())
            sums.append(total[:k, 0].float())
    return torch.cat(nexts), torch.cat(sums)


def reference_lm(lm_cfg: dict, state: dict, device) -> ref.CharLM:
    return ref.CharLM(state, lm_cfg["config"],
                      assets.read_lm_dict(lm_cfg["dict"]), device)


def token_flops(lm_cfg: dict, context: float) -> float:
    c = lm_cfg["config"]
    return roofline.lm_token_flops(context, c["d_model"], c["n_layers"],
                                   c["d_ff"], c["vocab_size"])
