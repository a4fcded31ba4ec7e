"""Text <-> binary payload converter (counterpart of
``trackmaker_tpu/utils/bintxt.py``): MSB-first text/bit-string conversion
used to prepare INPUT*.bin files."""

from __future__ import annotations

import numpy as np


def text_to_bits(text: str | bytes) -> str:
    data = text.encode() if isinstance(text, str) else bytes(text)
    return "".join(
        format(b, "08b") for b in data)


def bits_to_text(bits: str) -> bytes:
    bits = bits.strip().replace(" ", "").replace("\n", "")
    n = (len(bits) // 8) * 8
    arr = np.asarray([1 if c == "1" else 0 for c in bits[:n]], np.uint8)
    return np.packbits(arr).tobytes()


def text_file_to_bin(src, dst) -> None:
    import pathlib
    data = pathlib.Path(src).read_bytes()
    pathlib.Path(dst).write_bytes(data)


def bits_file_to_text(src, dst) -> None:
    import pathlib
    bits = pathlib.Path(src).read_text()
    pathlib.Path(dst).write_bytes(bits_to_text(bits))
