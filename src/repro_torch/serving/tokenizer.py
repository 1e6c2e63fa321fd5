"""Byte-level tokenizer: ids 0-255 = bytes, 256 = BOS, 257 = EOS.

No external vocab needed offline; any model config with vocab >= 258 can
serve text.
"""
from __future__ import annotations

from typing import List

import numpy as np

BOS = 256
EOS = 257
MIN_VOCAB = 258


class ByteTokenizer:
    bos_id = BOS
    eos_id = EOS

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([BOS] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in np.asarray(ids).tolist()
                   if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="replace")
