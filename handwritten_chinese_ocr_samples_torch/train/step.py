"""Train and eval steps and the optimizer (the JAX package's
``train/step.py``).

Training semantics of the reference trainer (`main.py:180-475`), as the JAX
package has them:

  * the optimizer is the optax chain clip by global norm 5.0 -> add
    ``weight_decay * p`` -> SGD with momentum (``t = g + 0.9 t``, no
    dampening) or Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), the
    model's ``optimizer`` attribute choosing; the clip is optax's
    ``g / |g| * 5`` where ``|g| >= 5`` (``clip_grad_norm_`` adds 1e-6);
  * step-decay LR: ``lr * 0.1 ** (epoch // 30)`` (`main.py:579-584`), set
    per epoch by ``adjust_learning_rate``;
  * a batch whose loss or gradient norm is not finite is skipped: the
    parameters, BatchNorm statistics and optimizer state stay as they were
    (`main.py:411-415`). The choice is made on the device by ``torch.where``
    over every tensor, so a step has no device-to-host copy; the step counter
    moves on either way, as in JAX;
  * dropout masks are seeded by ``fold_in(dropout_seed, step)``, the
    counterpart of ``jax.random.fold_in(dropout_rng, state.step)``;
  * under a process group (``parallel/mesh.py``, ``cli/train.py
    --distributed``) each rank steps on its rows of the global batch; the
    loss and the flat gradient list are averaged over the ranks before the
    update (no ``DistributedDataParallel``: its hooks do not fire on
    ``torch.autograd.grad``) and BatchNorm's statistics are the global
    batch's, so the step is the one-process step on the whole batch.

The classification steps (``pred == "Classification"``, the
``innovation`` classifier) share all of this: the loss is the mean softmax
cross-entropy of the f32 logits (``F.cross_entropy``), the metrics add the
batch's top-1 accuracy, and the eval step returns argmax class ids
(``torch.argmax`` takes the first of equal maxima, as ``jnp.argmax``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..ops.ctc import ctc_loss_mean, widths_to_paddings
from ..ops.decode import greedy_decode_device
from ..ops.dropout import fold_in
from ..parallel import mesh

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class Optimizer:
    """clip -> weight decay -> SGD-momentum or Adam; the learning rate lives
    in the state (``opt_state["learning_rate"]``), as optax's
    ``inject_hyperparams`` keeps it."""

    kind: str
    lr: float
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_norm: float = 5.0

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        def zeros():
            return {n: torch.zeros_like(p) for n, p in params.items()}
        if self.kind == "SGD":
            return {"learning_rate": self.lr, "trace": zeros()}
        device = next(iter(params.values())).device
        return {"learning_rate": self.lr,
                "count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt_state: dict,
               names: List[str], params: List[torch.Tensor],
               grad_norm: torch.Tensor):
        """-> (new params, new optimizer state), out of place."""
        lr = opt_state["learning_rate"]
        factor = torch.where(grad_norm < self.clip_norm, 1.0,
                             self.clip_norm / grad_norm)
        g = torch._foreach_mul(grads, factor)
        g = torch._foreach_add(g, params, alpha=self.weight_decay)
        if self.kind == "SGD":
            trace = torch._foreach_add(
                g, [opt_state["trace"][n] for n in names],
                alpha=self.momentum)
            new_params = torch._foreach_add(params, trace, alpha=-lr)
            return new_params, {"learning_rate": lr,
                                "trace": dict(zip(names, trace))}
        mu = torch._foreach_mul([opt_state["mu"][n] for n in names], ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
        nu = torch._foreach_mul([opt_state["nu"][n] for n in names], ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - ADAM_B2)
        count = opt_state["count"] + 1
        c = count.float()
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(ADAM_B1, c))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(ADAM_B2, c))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS)
        u = torch._foreach_div(mu_hat, denom)
        new_params = torch._foreach_add(params, u, alpha=-lr)
        return new_params, {"learning_rate": lr, "count": count,
                            "mu": dict(zip(names, mu)),
                            "nu": dict(zip(names, nu))}


def make_optimizer(kind: str = "SGD", lr: float = 0.001,
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   clip_norm: float = 5.0) -> Optimizer:
    """clip(5.0) -> weight decay -> SGD-momentum/Adam, LR injectable."""
    if kind not in ("SGD", "Adam"):
        raise ValueError(f"not expected optimizer: {kind}")
    return Optimizer(kind, lr, momentum, weight_decay, clip_norm)


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer and
    its state, and the host step counter."""

    module: torch.nn.Module
    tx: Optimizer
    opt_state: dict
    step: int = 0

    @classmethod
    def create(cls, module: torch.nn.Module, tx: Optimizer) -> "TrainState":
        return cls(module, tx, tx.init(dict(module.named_parameters())))


def adjust_learning_rate(state: TrainState, base_lr: float, epoch: int,
                         decay_epochs: int = 30) -> TrainState:
    """``lr = base_lr * 0.1 ** (epoch // decay_epochs)``; the reference
    hardcodes the 30-epoch interval (`main.py:579-584`)."""
    state.opt_state["learning_rate"] = base_lr * (
        0.1 ** (epoch // max(decay_epochs, 1)))
    return state


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _keep_if_finite(old: List[torch.Tensor], new: List[torch.Tensor],
                    finite: torch.Tensor) -> None:
    for o, n in zip(old, new):
        o.copy_(torch.where(finite, n, o))


def _update(state: TrainState, names, params, loss: torch.Tensor,
            grads) -> tuple:
    """Clip, optimizer, and the non-finite skip of one step, on the
    device; moves the step counter. Under a process group the loss and the
    gradients are first averaged over the ranks, so that the clip, the
    skip and the update see the global batch's and every rank takes the
    same step. Returns ``(loss, grad_norm, finite)``."""
    with torch.no_grad():
        loss, grads = mesh.all_reduce_mean(loss.detach(), grads)
        grad_norm = global_norm(list(grads))
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        new_params, new_opt = state.tx.update(
            list(grads), state.opt_state, list(names), list(params),
            grad_norm)
        _keep_if_finite(list(params), new_params, finite)
        for key, value in new_opt.items():
            if isinstance(value, dict):
                _keep_if_finite([state.opt_state[key][n] for n in names],
                                [value[n] for n in names], finite)
            elif isinstance(value, torch.Tensor):
                _keep_if_finite([state.opt_state[key]], [value], finite)
        for bn in state.module.batch_norms():
            _keep_if_finite([bn.running_mean, bn.running_var],
                            list(bn.new_running_stats()), finite)
    state.step += 1
    return loss, grad_norm, finite


def make_train_step(use_width_mask: bool = False):
    """The train step: forward, CTC, backward, clip, update, skip.

    ``use_width_mask=False`` is the reference: every example's CTC input
    length is the full padded width (`main.py:388`); ``True`` masks pad
    frames by true image width. ``batch`` holds ``images`` (B, H, W, 1) and
    ``labels`` (B, L) on the model's device, ``label_paddings`` (B, L) and
    ``widths`` (B,) on the CPU (the CTC lengths, read there without a copy
    from the device).
    """

    def train_step(state: TrainState, batch: dict, dropout_seed: int):
        model = state.module
        model.train()
        images = batch["images"]
        T = images.shape[2]
        logit_paddings = (widths_to_paddings(batch["widths"], T)
                          if use_width_mask else None)
        names, params = zip(*model.named_parameters())
        logits = model(images, dropout_seed=fold_in(dropout_seed,
                                                     state.step))
        loss = ctc_loss_mean(logits, batch["labels"],
                             batch["label_paddings"], logit_paddings)
        grads = torch.autograd.grad(loss, params)
        loss, grad_norm, finite = _update(state, names, params, loss,
                                          grads)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "skipped": (~finite).float()}
        return state, metrics

    return train_step


def make_classify_train_step():
    """The train step of a ``pred == "Classification"`` model: forward,
    mean softmax cross-entropy on the f32 ``(B, num_classes)`` logits,
    backward, clip, update, skip. ``batch`` holds ``images`` (B, H, W, 1)
    and ``labels`` (B,) class ids on the model's device."""

    def train_step(state: TrainState, batch: dict, dropout_seed: int):
        model = state.module
        model.train()
        labels = batch["labels"].long()
        names, params = zip(*model.named_parameters())
        logits = model(batch["images"], dropout_seed=fold_in(dropout_seed,
                                                             state.step))
        loss = F.cross_entropy(logits.float(), labels)
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        grads = torch.autograd.grad(loss, params)
        loss, grad_norm, finite = _update(state, names, params, loss,
                                          grads)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "acc": acc, "skipped": (~finite).float()}
        return state, metrics

    return train_step


def make_classify_eval_step(model: torch.nn.Module):
    """Eval of a classifier: forward in eval mode -> int32 argmax class
    ids."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(images).argmax(dim=-1).to(torch.int32)

    return eval_step


def make_eval_step(model: torch.nn.Module, unknown_id: int,
                   use_width_mask: bool = False):
    """Eval: forward in eval mode + greedy collapse on the device ->
    compact ``(chars, lengths)``."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, widths: torch.Tensor):
        model.eval()
        logits = model(images)
        return greedy_decode_device(
            logits, widths if use_width_mask else None,
            unknown_id=unknown_id)

    return eval_step
