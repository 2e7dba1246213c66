"""Contrastive (CLIP) text inputs.

Counterpart of ``clip_tokenize`` in the JAX package's
``train/contrastive.py``; the training loops there are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..chem import tokenizer as chem_tokenizer


def clip_tokenize(smiles_list, max_len: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Framed character-level ids for the text tower and the attention mask
    (1 = real token), int32 [len(smiles_list), max_len] each."""
    toks = np.zeros((len(smiles_list), max_len), np.int32)
    mask = np.zeros((len(smiles_list), max_len), np.int32)
    for i, s in enumerate(smiles_list):
        ids, pad_mask = chem_tokenizer.encode_smiles_framed(s, max_len)
        toks[i] = ids
        mask[i] = 1 - np.asarray(pad_mask, np.int32)
    return toks, mask
