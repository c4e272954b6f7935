"""Native (C++) host beam search — ctypes wrapper over the port's own
``native/cbs_decoder.cc`` (the JAX package's ``decode/beam_host_native.py``).

The n-gram serving route (the reference's deployment with ``-kp``,
`deploy.py:76-87`) decodes each line with the context beam search and an
n-gram LM on the host. The Python decoder (``beam_host.py``) is the oracle
but loops per (frame, beam, candidate) in the interpreter; the C++ version
gives the same texts at native speed, with the ARPA/HBLM Katz-backoff
scorer of ``kenlm.Model.score`` semantics (`ctc_codec.py:120-122,276-281`).

The library is compiled from ``native/cbs_decoder.cc`` with the host C++
compiler at first use (``ops/_build.load_host``); a failed build raises.
It covers the configurations whose LM lives on the host: no-LM beam search
and n-gram-scored beam search, full or skip mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import numpy as np

from ..ops import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C ABI declared (raises if it cannot be
    built)."""
    lib = _build.load_host("cbs_decoder")
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.cbs_arpa_load.restype = ctypes.c_void_p
    lib.cbs_arpa_load.argtypes = [ctypes.c_char_p]
    lib.cbs_arpa_free.argtypes = [ctypes.c_void_p]
    lib.cbs_arpa_order.restype = ctypes.c_int
    lib.cbs_arpa_order.argtypes = [ctypes.c_void_p]
    lib.cbs_arpa_unk_id.restype = ctypes.c_int
    lib.cbs_arpa_unk_id.argtypes = [ctypes.c_void_p]
    lib.cbs_arpa_word_id.restype = ctypes.c_int
    lib.cbs_arpa_word_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cbs_arpa_score_ids.restype = ctypes.c_double
    lib.cbs_arpa_score_ids.argtypes = [ctypes.c_void_p, c_i32p,
                                       ctypes.c_int, ctypes.c_int]
    lib.cbs_create.restype = ctypes.c_void_p
    lib.cbs_create.argtypes = [
        ctypes.c_void_p, c_i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int]
    lib.cbs_free.argtypes = [ctypes.c_void_p]
    lib.cbs_decode.restype = ctypes.c_int
    lib.cbs_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, c_i32p, ctypes.c_int]
    return lib


class NativeArpaLM:
    """C++ n-gram model handle (ARPA text or HBLM; kenlm ``score``
    semantics, log10). Raises ``ValueError`` for a file it cannot read."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.cbs_arpa_load(path.encode())
        if not self._h:
            raise ValueError(f"failed to load ARPA/HBLM file {path}")
        self.order = self._lib.cbs_arpa_order(self._h)
        self.unk_id = self._lib.cbs_arpa_unk_id(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cbs_arpa_free(self._h)
            self._h = None

    def word_id(self, word: str) -> int:
        """Id of a known word, or the <unk> id."""
        wid = self._lib.cbs_arpa_word_id(self._h, word.encode())
        return self.unk_id if wid < 0 else wid

    def score_words(self, words: List[str], eos: bool = False) -> float:
        ids = np.array([self.word_id(w) for w in words], np.int32)
        return float(self._lib.cbs_arpa_score_ids(
            self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ids.size, int(eos)))

    def score(self, sentence: str, bos: bool = True,
              eos: bool = True) -> float:
        """Same surface as ``lm.arpa.ArpaLM.score`` (bos must be True: the
        decoder never scores without it)."""
        if not bos:
            raise NotImplementedError("native scorer always uses <s>")
        return self.score_words(sentence.split(), eos=eos)


class NativeBeamSearchDecoder:
    """Drop-in for ``BeamSearchDecoder`` on host-LM configurations.

    ``config`` is a ``beam_host.BeamSearchConfig``; ``use_lm_pred`` must be
    False (n-gram LMs propose no candidates) and the LM, when scoring is
    on, is an ARPA or HBLM file path.
    """

    def __init__(self, codec, config, arpa_path: Optional[str] = None):
        if config.use_lm_pred:
            raise ValueError("native CBS has no LM candidate proposal; the "
                             "Python host beam serves LM proposals")
        self._lib = _lib()
        self.codec = codec
        self.cfg = config
        self._arpa = None
        lm_handle = None
        c2w = None
        use_score = bool(config.use_lm_score and arpa_path)
        if use_score:
            self._arpa = NativeArpaLM(arpa_path)
            lm_handle = self._arpa._h
            mapping = np.full((codec.num_classes,), self._arpa.unk_id,
                              np.int32)
            for ch, cid in codec.dict.items():
                if ch not in ("<blank>", "<unknown>"):
                    mapping[cid] = self._arpa.word_id(ch)
            c2w = mapping.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            self._c2w_keepalive = mapping
        self._h = self._lib.cbs_create(
            lm_handle, c2w, codec.num_classes, codec.unknown_id,
            config.beam_size, config.search_depth,
            float(config.lm_panelty), float(config.len_bonus),
            int(use_score), int(config.skip_search),
            float(config.prune_log_prob), int(config.suffix_len))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cbs_free(self._h)
            self._h = None

    def decode(self, preds: np.ndarray, already_log: bool = False
               ) -> List[str]:
        """``preds``: (T, B, D) logits or log-probs -> list of B texts."""
        T, B, D = preds.shape
        out = np.zeros((T,), np.int32)
        texts = []
        for b in range(B):
            frame = np.ascontiguousarray(preds[:, b, :], np.float32)
            n = self._lib.cbs_decode(
                self._h,
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                T, D, int(already_log),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out.size)
            texts.append("".join(self.codec.characters[i]
                                 for i in out[:n]))
        return texts


def native_reads(path: str) -> bool:
    """Whether ``path`` is a file format the native reader takes: an HBLM
    binary, or a text ARPA (its first non-blank line is ``\\data\\``)."""
    from ..lm.hblm import is_hblm
    if is_hblm(path):
        return True
    with open(path, "rb") as f:
        return f.read(4096).lstrip().startswith(b"\\data\\")


def try_native_host_decoder(codec, cfg, lm=None, kenlm_path: str = ""):
    """The native decoder for a qualifying host-beam configuration, or None.

    Qualifies when no LM candidate proposal is asked for and LM scoring,
    if on, comes from an n-gram file in a format the native reader takes
    (``native_reads``): the reference's n-gram serving configuration and
    the no-LM beam. LM proposals, and a transformer LM's scores, stay with
    the Python decoder; so does an n-gram file in another format (a binary
    KenLM ``.klm``, a compressed ARPA), which ``lm_interface.KenLMBackend``
    reads or refuses. A library that does not build, or a file of a native
    format that does not load, raises here.
    """
    if cfg.use_lm_pred:
        return None
    if cfg.use_lm_score:
        path = kenlm_path or getattr(lm, "path", "")
        if not path or not native_reads(path):
            return None
        return NativeBeamSearchDecoder(codec, cfg, arpa_path=path)
    return NativeBeamSearchDecoder(codec, cfg)
