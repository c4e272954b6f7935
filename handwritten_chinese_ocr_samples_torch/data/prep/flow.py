"""Dataset preparation flow: code<->char maps, manifests, vocabulary.

Parity with the reference flow (`preparation_flow.py:10-238`):

  * GB/UTF-16 hex-code -> char mapping, including the ICDAR2013 label-bug
    fix (``FDA3`` -> ``A3FD``, `preparation_flow.py:77-79`) and the ``FFFF``
    skip;
  * ``generate_char_img_gt``: HWDB1.x filenames (``<gnt>_<dec tag>.png``) ->
    ``path,HEXCODE`` manifest + code class list;
  * ``generate_text_img_gt``: per-line hex label files -> ``img,chars``
    manifest + code class list;
  * ``generate_codes_list`` merge -> the 7,373-entry vocabulary
    (`preparation_flow.py:174`);
  * ``select_alpha_symbol_codes``: GBK A1xx-A9xx rows and UTF-16 xx00 codes,
    kept verbatim during synthesis (`preparation_flow.py:120-138`).

The final dataset layout (train/val/test splits) follows the data strategy
documented at `preparation_flow.py:227-238`; ``build_split`` implements the
90/10 shuffle-split from the reference quickstart (`colab_train.ipynb`
cell 12, seed 42).

A copy of the JAX package's ``data/prep/flow.py`` (standard library only).
"""

from __future__ import annotations

import codecs
import os
import random
import shutil
from typing import List, Sequence


def map_code_to_char(code: str) -> str:
    """4-hex-digit label code -> character.

    Codes ending ``00`` are UTF-16; others are GBK
    (`preparation_flow.py:10-19`).
    """
    if len(code) != 4:
        raise AssertionError(code)
    raw = codecs.decode(code, "hex_codec")
    if code[2:4] == "00":
        return raw.decode("utf-16")
    return raw.decode("gbk")


def map_codes_to_chars(codes: Sequence[str]) -> List[str]:
    return [map_code_to_char(c) for c in codes]


def generate_char_img_gt(img_path: str, out_file_path: str) -> List[str]:
    """HWDB1.x image folder -> ``path,HEX`` manifest; returns code classes.

    Filenames encode the tag as a decimal int (``..._45217.png`` -> hex
    ``B0A1``), matching `preparation_flow.py:31-50`.
    """
    codes: List[str] = []
    seen = set()
    with open(out_file_path, "w", encoding="utf-8") as out:
        for image in sorted(os.listdir(img_path)):
            dec_str = image.split("_")[-1].split(".")[0]
            hex_code = format(int(dec_str), "X")
            out.write(f"{os.path.join(img_path, image)},{hex_code}\n")
            if hex_code not in seen:
                seen.add(hex_code)
                codes.append(hex_code)
    return codes


def generate_text_img_gt(data_path: str, out_file_path: str) -> List[str]:
    """Folder of ``X.png`` + ``X.txt`` (hex codes per line) ->
    ``img,chars`` manifest; returns code classes (`preparation_flow.py:53-87`).
    """
    codes: List[str] = []
    seen = set()
    with open(out_file_path, "w", encoding="utf-8") as out:
        for label_f in sorted(os.listdir(data_path)):
            if not label_f.endswith(".txt"):
                continue
            img_name = label_f[:-4] + ".png"
            if not os.path.isfile(os.path.join(data_path, img_name)):
                continue
            chars = []
            with open(os.path.join(data_path, label_f), "r",
                      encoding="utf-8") as f:
                for line in f:
                    code = line.strip("\n")
                    if code == "FFFF":
                        continue
                    if code == "FDA3":  # ICDAR2013 label bug
                        code = "A3FD"
                    chars.append(map_code_to_char(code))
                    if code not in seen:
                        seen.add(code)
                        codes.append(code)
            out.write(f"{img_name},{''.join(chars)}\n")
    return codes


def generate_codes_list(*code_lists: Sequence[str]) -> List[str]:
    """Merge code lists preserving first-seen order
    (`preparation_flow.py:90-105`)."""
    merged: List[str] = []
    seen = set()
    for lst in code_lists:
        for code in lst:
            if code not in seen:
                seen.add(code)
                merged.append(code)
    return merged


def select_alpha_symbol_codes(codes: Sequence[str]) -> List[str]:
    """Alphanumeric/symbol codes: GBK rows A1-A9 or UTF-16 ``xx00``
    (`preparation_flow.py:120-138`)."""
    out = []
    for code in codes:
        if code[0:2] in ("A1", "A2", "A3", "A4", "A5", "A6", "A7", "A8",
                         "A9") or code[2:4] == "00":
            out.append(code)
    return out


def save_list_to_file(items: Sequence[str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for item in items:
            f.write(item + "\n")


def build_split(manifests: Sequence[str], data_root: str,
                val_fraction: float = 0.1, seed: int = 42,
                test_manifest: str | None = None) -> None:
    """Assemble the training layout from extraction manifests.

    Merges ``img,label`` manifests, shuffles with ``seed`` (the reference
    quickstart uses seed 42), splits off ``val_fraction`` for validation,
    and writes ``{train,val,test}_img_id_gt.txt`` under ``data_root``.
    Images are expected in ``data_root/{train,val,test}/``.
    """
    rows: List[str] = []
    for m in manifests:
        with open(m, "r", encoding="utf-8") as f:
            rows.extend(line.rstrip("\n") for line in f if line.strip())
    rng = random.Random(seed)
    rng.shuffle(rows)
    n_val = int(len(rows) * val_fraction)
    val_rows, train_rows = rows[:n_val], rows[n_val:]
    save_list_to_file(train_rows,
                      os.path.join(data_root, "train_img_id_gt.txt"))
    save_list_to_file(val_rows, os.path.join(data_root, "val_img_id_gt.txt"))
    if test_manifest:
        shutil.copyfile(test_manifest,
                        os.path.join(data_root, "test_img_id_gt.txt"))


def build_vocabulary(codes: Sequence[str], out_path: str) -> List[str]:
    """codes -> chars_list.txt (one char per line)."""
    chars = map_codes_to_chars(codes)
    save_list_to_file(chars, out_path)
    return chars
