"""Language-model backends for beam-search fusion (the JAX package's
``decode/lm_interface.py``).

The reference fuses two LM families into beam search (`ctc_codec.py:101-122`):
a KenLM character n-gram (scoring) and a transformer LM (scoring and/or
next-character prediction, `transformer_infer.py`). Both sit behind one
small protocol, so the host decoder does not care which it has:

  * ``score_batch(texts)``: a log-probability score per text (the n-gram
    scores space-joined characters with ``eos=False``, as
    `ctc_codec.py:276-281` does);
  * ``topk_next(texts, k)``: the k likeliest next characters per text
    (`transformer_infer.py:62-76`).

``TorchLMBackend`` also holds the char transformer the LM-fused device
search runs: ``lm_model`` (a ``lm/model.CharTransformerLM``), ``lm_params``
(its state dict) and ``tokenizer``. The serving engine and the eval driver
tell a transformer LM apart by ``hasattr(lm, "lm_model")``, as the JAX
package does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np
import torch


class LMBackend(Protocol):
    def score_batch(self, texts: Sequence[str]) -> np.ndarray: ...
    def topk_next(self, texts: Sequence[str], k: int) -> List[List[str]]: ...


class NullLM:
    """No language model: zero scores, no linguistic candidates."""

    def score_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.zeros((len(texts),), dtype=np.float64)

    def topk_next(self, texts: Sequence[str], k: int) -> List[List[str]]:
        return [[] for _ in texts]


class KenLMBackend:
    """N-gram scoring, space-joined characters, no EOS
    (`ctc_codec.py:120-122,276-281`).

    Takes the first-party HBLM binary (``lm/hblm.py``), then a text ARPA
    through the ``kenlm`` package when it is importable, else through the
    first-party reader (``lm/arpa.py``, ``kenlm.Model.score`` exactly); a
    binary KenLM ``.klm`` file needs ``kenlm`` and raises without it.
    """

    def __init__(self, model_path: str):
        self.path = model_path
        from ..lm.hblm import HblmLM, is_hblm
        if is_hblm(model_path):
            self.model = HblmLM(model_path)
            return
        try:
            import kenlm  # optional dependency, as in the reference
            self.model = kenlm.Model(model_path)
        except ImportError:
            from ..lm.arpa import ArpaLM
            try:
                self.model = ArpaLM(model_path)
            except (UnicodeDecodeError, ValueError) as e:
                raise ValueError(
                    f"{model_path}: neither text ARPA nor HBLM. Binary "
                    "KenLM (.klm) needs the `kenlm` package, which is not "
                    "installed; pass the text ARPA or an HBLM file made "
                    "from it (lm/hblm.build_hblm) instead."
                ) from e

    def score_batch(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts),), dtype=np.float64)
        for i, t in enumerate(texts):
            out[i] = self.model.score(" ".join(t), eos=False)
        return out

    def topk_next(self, texts: Sequence[str], k: int) -> List[List[str]]:
        return [[] for _ in texts]


class TorchLMBackend:
    """The char transformer: its module, state dict and tokenizer, for the
    device search; ``score_batch`` and ``topk_next`` for the host beam run
    through an ``lm/infer.LMScorer`` on ``device``, built at first use
    (``to`` moves it)."""

    def __init__(self, lm_model, lm_params: Dict[str, torch.Tensor],
                 tokenizer, device: str | torch.device = "cuda"):
        self.lm_model = lm_model
        self.lm_params = lm_params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self._scorer = None

    def to(self, device: str | torch.device) -> "TorchLMBackend":
        device = torch.device(device)
        if device != self.device:
            self.device, self._scorer = device, None
        return self

    @property
    def scorer(self):
        if self._scorer is None:
            from ..lm.infer import LMScorer
            self._scorer = LMScorer(self.lm_model, self.lm_params,
                                    self.tokenizer, device=self.device)
        return self._scorer

    def score_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray(self.scorer.score(list(texts), char_based=True))

    def topk_next(self, texts: Sequence[str], k: int) -> List[List[str]]:
        return self.scorer.next_k_words(list(texts), k, char_based=True)


def build_lm_backend(tfm_path: str = "", kenlm_path: str = "",
                     use_tfm: bool = False,
                     chars_list: Optional[str] = None):
    """The LM backend of CLI-style flags (`ctc_codec.py:101-122`), shared by
    the eval driver and the deploy CLI: the transformer when ``use_tfm``
    and ``tfm_path`` (an LM directory or ``seed:<n>``, ``lm/io.load_lm``;
    a seeded LM takes its vocabulary from ``chars_list``), else the n-gram
    of ``kenlm_path``; None when no LM is asked for."""
    if use_tfm and tfm_path:
        from ..lm.io import load_lm
        return TorchLMBackend(*load_lm(tfm_path, chars_list=chars_list))
    if kenlm_path:
        return KenLMBackend(kenlm_path)
    return None
