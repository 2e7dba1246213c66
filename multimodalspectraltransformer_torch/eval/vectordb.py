"""Fingerprint vector DB: encode molecules into fingerprint vectors, store
them, and retrieve nearest neighbours on the device.

Counterpart of the JAX package's ``eval/vectordb.py``: a structural DB of
Morgan bits (``build_morgan_db``) or a learned one of the MMT fingerprint
head's 512-d vectors (``build_model_db``); ``save``/``load`` use the same
``.npz`` and ``.json`` files, so each package reads the other's, and
``export_csv`` writes the bytes the JAX package's pandas export writes.
Retrieval rounds queries and DB to bfloat16 and multiplies them in float32
(what the JAX function's ``preferred_element_type=float32`` product does),
then takes the top k with ties to the lower index, as ``jax.lax.top_k``.
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..chem import api as chem
from ..utils.device import DeviceLike, resolve_device


@dataclass
class VectorDB:
    smiles: list[str]
    vectors: np.ndarray  # [N, D] float32 (learned fp) or uint8 (Morgan bits)
    kind: str = "morgan"  # "morgan" | "model"

    def __len__(self) -> int:
        return len(self.smiles)

    def save(self, path: str) -> None:
        np.savez_compressed(path + ".npz", vectors=self.vectors)
        with open(path + ".json", "w") as f:
            json.dump({"smiles": self.smiles, "kind": self.kind}, f)

    @staticmethod
    def load(path: str) -> "VectorDB":
        with open(path + ".json") as f:
            meta = json.load(f)
        vectors = np.load(path + ".npz")["vectors"]
        return VectorDB(meta["smiles"], vectors, meta["kind"])

    def export_csv(self, path: str) -> None:
        """Reference-format CSV: a SMILES column and one column per
        dimension, formatted as pandas' ``to_csv`` formats them (numpy's
        shortest repr of each value, NaN as an empty field)."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["SMILES"] + [str(i) for i in range(self.vectors.shape[1])])
            for smi, row in zip(self.smiles, self.vectors):
                w.writerow([smi] + ["" if np.isnan(x) else str(x) for x in row])


def build_morgan_db(smiles_list: Sequence[str], n_bits: int = 512) -> VectorDB:
    """Structural DB from Morgan fingerprints (native batch kernel)."""
    fps, valid = chem.batch_morgan_fp(smiles_list, n_bits=n_bits)
    keep = [i for i in range(len(smiles_list)) if valid[i]]
    return VectorDB([smiles_list[i] for i in keep], fps[keep], kind="morgan")


@torch.no_grad()
def build_model_db(records: Sequence, model, batch_size: int = 256,
                   device: DeviceLike = None) -> VectorDB:
    """Learned DB: the MMT encoder's fingerprint head output per record that
    featurizes, encoded in float32 on ``device`` (cuda unless asked
    otherwise) ``batch_size`` records at a time."""
    from ..data import pipeline as dp
    from ..models.mmt import MMTBatch

    dev = resolve_device(device)
    model = model.to(dev).eval()
    feats = [f for f in (dp.featurize(r, model.cfg) for r in records) if f is not None]
    smiles: list[str] = []
    vecs: list[np.ndarray] = []
    for lo in range(0, len(feats), batch_size):
        chunk = feats[lo : lo + batch_size]
        fp = model.encode(MMTBatch(*dp.collate(chunk).inputs).to(dev)).fingerprint
        smiles += [f["smiles"] for f in chunk]
        vecs.append(fp.float().cpu().numpy())
    vectors = np.concatenate(vecs) if vecs else np.zeros((0, model.cfg.fingerprint_size), np.float32)
    return VectorDB(smiles, vectors, kind="model")


# ---------------------------------------------------------------------------
# device retrieval
# ---------------------------------------------------------------------------

def topk_scores(queries: torch.Tensor, db: torch.Tensor, k: int, metric: str):
    """[Q, D] vs [N, D] float32 -> (scores [Q, k], idx [Q, k]): the product of
    the bfloat16-rounded operands in float32, the metric, and the k best per
    row, equal scores in index order (a stable descending sort)."""
    inter = queries.to(torch.bfloat16).float() @ db.to(torch.bfloat16).float().T
    if metric == "dot":
        scores = inter
    elif metric == "cosine":
        qn = torch.linalg.norm(queries, dim=1, keepdim=True)
        dn = torch.linalg.norm(db, dim=1, keepdim=True)
        scores = inter / torch.clamp_min(qn * dn.T, 1e-9)
    elif metric == "tanimoto":
        # binary fingerprints: |a&b| / (|a| + |b| - |a&b|)
        union = queries.sum(dim=1, keepdim=True) + db.sum(dim=1, keepdim=True).T - inter
        scores = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    elif metric == "euclidean":
        # negative distance so the top k are the nearest
        qq = (queries**2).sum(dim=1, keepdim=True)
        dd = (db**2).sum(dim=1, keepdim=True)
        scores = -(qq + dd.T - 2.0 * inter)
    else:
        raise ValueError(metric)
    scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


def query(db: VectorDB, query_vectors: np.ndarray, k: int = 10, metric: Optional[str] = None,
          device: DeviceLike = None) -> tuple[np.ndarray, np.ndarray, list[list[str]]]:
    """Top-k retrieval on ``device`` (cuda unless asked otherwise). Returns
    (scores [Q, k], indices [Q, k], SMILES). Default metric: tanimoto for
    Morgan DBs, cosine for model DBs."""
    if metric is None:
        metric = "tanimoto" if db.kind == "morgan" else "cosine"
    dev = resolve_device(device)
    k = min(k, len(db))
    to_dev = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    scores, idx = topk_scores(to_dev(query_vectors), to_dev(db.vectors), k, metric)
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy().astype(np.int32)
    names = [[db.smiles[j] for j in row] for row in idx]
    return scores, idx, names


def query_smiles(db: VectorDB, smiles_list: Sequence[str], k: int = 10,
                 metric: Optional[str] = None, device: DeviceLike = None):
    """Query a Morgan DB directly by SMILES: (scores, indices, SMILES, valid)."""
    fps, valid = chem.batch_morgan_fp(smiles_list, n_bits=db.vectors.shape[1])
    scores, idx, names = query(db, fps, k, metric, device)
    return scores, idx, names, valid
