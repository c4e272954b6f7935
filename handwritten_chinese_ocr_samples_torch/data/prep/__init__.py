"""Offline CASIA-HWDB dataset preparation (the JAX package's
``data/prep``, copies: numpy and the standard library, OpenCV only where an
image is resized or written).

  * ``gnt``  — HWDB1.x GNT isolated-character extractor
  * ``flow`` — code<->char mapping, manifest + vocabulary builders

The HWDB2.x DGRL page extractor and the native ``dgr2png`` are not ported
yet (ROADMAP.md queue 1, item 9.6).
"""

from .gnt import gnt2png, iter_gnt_samples  # noqa: F401
from .flow import (  # noqa: F401
    map_code_to_char, generate_char_img_gt, generate_text_img_gt,
    generate_codes_list, select_alpha_symbol_codes,
)
