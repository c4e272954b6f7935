"""Training loop for the char LM (the JAX package's ``lm/train.py``).

Next-token cross-entropy with the tokenizer's eos-fill: position ``t``
predicts token ``t + 1``, and the loss of a sentence runs over its ``len +
1`` positions (its characters and the closing ``</s>``), divided by the
count of those positions in the batch.

The optimizer is the JAX package's optax chain ``clip_by_global_norm(1.0)
-> adamw(schedule, weight_decay=0.01)``, written out (``AdamW``): clip ->
Adam moments -> ``+ 0.01 * p`` (every parameter decays: LayerNorms, biases,
``pos_embed`` and the tied embedding too) -> ``* -lr(count)``. The schedule
(``lm_schedule``) is a linear warm-up from 0 joined to a cosine decay,
evaluated at the count of updates made before this one, so the first
update has learning rate 0.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..train.step import ADAM_B1, ADAM_B2, ADAM_EPS, global_norm
from ..utils.weights import init_lm_state_dict
from .model import CharTransformerLM
from .tokenizer import Tokenizer


def lm_schedule(lr: float, warmup_steps: int,
                decay_steps: int) -> Callable[[int], float]:
    """optax's ``join_schedules([linear_schedule(0, lr, warmup_steps),
    cosine_decay_schedule(lr, decay_steps)], [warmup_steps])`` in f32, as
    a function of the update count. The warm-up is optax's to the bit; the
    cosine is rounded from a double, where XLA takes an f32 cosine, so the
    two part by about 1e-7 of ``lr``."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(f32(0.0 - lr) * frac) + f32(lr))
        t = f32(min(count - warmup_steps, decay_steps))
        arg = f32(math.pi) * t / f32(decay_steps)
        cosine = f32(0.5) * (f32(1) + f32(math.cos(float(arg))))
        return float(f32(lr) * cosine)

    return schedule


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay))`` over lists of tensors. The state holds the host count
    of updates and the moments; every step's tensors stay on the device,
    with nothing copied to the host."""

    def __init__(self, schedule: Callable[[int], float],
                 clip_norm: float = 1.0, weight_decay: float = 0.01):
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: dict,
               params: List[torch.Tensor]):
        """-> (new params, new state), out of place."""
        dev = params[0].device
        norm = global_norm(grads)
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                     self.clip_norm)
        keep = norm < self.clip_norm
        g = [torch.where(keep, a, b) for a, b in zip(grads, clipped)]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - ADAM_B1),
                                torch._foreach_mul(state["mu"], ADAM_B1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2),
            torch._foreach_mul(state["nu"], ADAM_B2))
        count = state["count"] + 1
        # divisions by a device tensor: CUDA divides by a Python number
        # as a multiply by its reciprocal
        bc1, bc2 = (torch.full((), float(np.float32(1) - np.float32(b)
                                         ** np.float32(count)),
                               dtype=torch.float32, device=dev)
                    for b in (ADAM_B1, ADAM_B2))
        u = torch._foreach_div(
            torch._foreach_div(mu, bc1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(nu, bc2)), ADAM_EPS))
        u = torch._foreach_add(u, torch._foreach_mul(params,
                                                     self.weight_decay))
        u = torch._foreach_mul(u, -self.schedule(state["count"]))
        return (torch._foreach_add(params, u),
                {"count": count, "mu": mu, "nu": nu})


def make_lm_train_step(model: CharTransformerLM, tx: AdamW):
    """``step(params, opt_state, tokens, lengths, generator) -> (params,
    opt_state, loss)``: ``params`` a state dict of ``model`` (left as it
    is), ``tokens (B, L)`` and ``lengths (B,)`` on its device, the dropout
    masks from ``generator`` (None at dropout 0). ``loss`` stays on the
    device."""

    def step(params: Dict[str, torch.Tensor], opt_state: dict,
             tokens: torch.Tensor, lengths: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        model.train()
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        logits = torch.func.functional_call(
            model, dict(zip(names, leaves)), (tokens,),
            {"generator": generator}, strict=True)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        L = nll.shape[1]
        mask = (torch.arange(L, device=tokens.device)[None, :]
                < (lengths[:, None] + 1)).float()
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        grads = torch.autograd.grad(loss, leaves)
        new, opt_state = tx.update(list(grads), opt_state,
                                   [p.detach() for p in leaves])
        return dict(zip(names, new)), opt_state, loss.detach()

    return step


def batches_from_corpus(
    lines: Sequence[str],
    tokenizer: Tokenizer,
    batch_size: int,
    max_len: int,
    seed: int = 0,
    char_based: bool = True,
) -> Iterable[tuple]:
    """Shuffle the lines (numpy's ``default_rng(seed).permutation``), cut
    each to ``max_len - 2``, and pad each batch to its longest line + 2
    rounded up to a multiple of 32 (at most ``max_len``); the last partial
    batch is dropped. Yields ``(tokens (B, L) int64, lengths (B,) int32)``
    CPU tensors."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(lines))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        chunk = [lines[j][: max_len - 2] for j in order[i: i + batch_size]]
        longest = max(len(s) for s in chunk) + 2
        L = min(-(-longest // 32) * 32, max_len)
        toks = tokenizer.tokenize(chunk, char_based=char_based, fixed_len=L)
        lengths = np.array([min(len(s), L - 2) for s in chunk], np.int32)
        yield torch.from_numpy(toks), torch.from_numpy(lengths)


def train_char_lm(
    corpus_lines: List[str],
    characters: str,
    epochs: int = 1,
    batch_size: int = 64,
    max_len: int = 256,
    lr: float = 5e-4,
    warmup_steps: int = 4000,
    d_model: int = 512,
    n_layers: int = 6,
    seed: int = 0,
    log_every: int = 100,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
):
    """Train a ``CharTransformerLM`` from flax's initialisation drawn from
    ``seed`` (``utils/weights.init_lm_state_dict``); returns ``(model,
    state dict, tokenizer)``, the state dict f32 on ``device``. ``generator``
    draws the dropout masks (default: one on ``device`` seeded with
    ``seed + 1``)."""
    device = torch.device(device)
    tokenizer = Tokenizer.from_characters(characters)
    model = CharTransformerLM(vocab_size=tokenizer.vocab_size,
                              d_model=d_model, n_layers=n_layers,
                              max_len=max_len, dtype=dtype)
    params = {k: v.to(device) for k, v in
              init_lm_state_dict(model.config(),
                                 torch.Generator().manual_seed(seed)).items()}
    model.load_state_dict(params)
    model.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed + 1)

    tx = AdamW(lm_schedule(
        lr, warmup_steps,
        max(1, epochs * max(1, len(corpus_lines) // batch_size))))
    opt_state = tx.init(list(params.values()))
    step_fn = make_lm_train_step(model, tx)

    step = 0
    t0 = time.time()
    for epoch in range(epochs):
        for toks, lengths in batches_from_corpus(
                corpus_lines, tokenizer, batch_size, max_len,
                seed=seed + epoch):
            params, opt_state, loss = step_fn(
                params, opt_state, toks.to(device, non_blocking=True),
                lengths.to(device, non_blocking=True), generator)
            step += 1
            if step % log_every == 0:
                loss = float(loss)
                print(f"lm step {step} epoch {epoch} loss {loss:.4f} "
                      f"ppl {math.exp(loss):.1f} ({time.time() - t0:.0f}s)")
    model.load_state_dict(params)
    model.eval()
    return model, params, tokenizer
