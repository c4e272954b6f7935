"""Offline CASIA-HWDB dataset preparation (the JAX package's
``data/prep`` and ``native/dgr2png.cc``): numpy and the standard library,
OpenCV only where an image is read, resized with OpenCV or written.

  * ``gnt``  — HWDB1.x GNT isolated-character extractor
  * ``dgrl`` — HWDB2.x DGRL page extractor (its LANCZOS resize the port's
    own resampler, equal byte for byte to PIL's)
  * ``dgr``  — DGR page extractor and text-line synthesizer (the C++
    ``dgr2png`` tool's CLI and outputs, in numpy and OpenCV's Python API)
  * ``flow`` — code<->char mapping, manifest + vocabulary builders
"""

from .gnt import gnt2png, iter_gnt_samples  # noqa: F401
from .dgrl import dgrl2png, iter_dgrl_lines  # noqa: F401
from .dgr import dgr2png  # noqa: F401
from .flow import (  # noqa: F401
    map_code_to_char, generate_char_img_gt, generate_text_img_gt,
    generate_codes_list, select_alpha_symbol_codes,
)
