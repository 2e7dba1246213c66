"""What several of the port's test modules share. A helper module, not a test
module: it imports neither JAX nor the JAX package."""

from __future__ import annotations

import importlib.util
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "runs", "accuracy_r3", "heldout_smiles.json")
RECORDS = os.path.join(REPO, "runs", "accuracy_r2b", "heldout_csv.tar.gz")


def load(rel: str):
    """A script or example of the repository (``rel`` from its root), loaded
    as a module."""
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3],
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def load_copy(rel: str, dest: str):
    """A script of the repository copied into ``dest/scripts/`` and loaded
    from there, so that the paths it derives from its own location (its
    repository root, its default outputs) point into ``dest``."""
    os.makedirs(os.path.join(dest, "scripts"), exist_ok=True)
    target = os.path.join(dest, "scripts", os.path.basename(rel))
    shutil.copy(os.path.join(REPO, rel), target)
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3] + "_copy", target)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def decoding_params(records: list, taught: dict, path: str, steps: int = 40) -> str:
    """ModelConfig.small() drawn from seed 0, whose decoder side (decoder,
    target embeddings, output layer) is then trained by Adam for ``steps``
    steps on the frozen encoder's memory of each record to decode
    ``taught[record's SMILES]``; exported to ``path`` as the flax file that
    both packages load. So both decode real molecules from one file, and the
    untrained encoder keeps the training to seconds on the CPU."""
    import numpy as np
    import torch

    from multimodalspectraltransformer_torch.data import pipeline as tdp
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import checkpoint
    from multimodalspectraltransformer_torch.utils import vocab
    from multimodalspectraltransformer_torch.utils.config import ModelConfig

    model = mmt.init_model(ModelConfig.small(), 0, "cpu").eval()
    feats = {r.smiles: tdp.featurize(r, model.cfg) for r in records}
    batch = tdp.to_device(tdp.collate([feats[r.smiles] for r in records]), "cpu")
    trg = torch.as_tensor(np.stack([feats[taught[r.smiles]]["trg_tokens"] for r in records]))
    trg = trg.long()
    enc = model.encode(batch.inputs)
    trained = [p for k, p in model.named_parameters()
               if k.startswith(("decoder", "embed_trg", "pe_trg", "fc_out"))]
    opt = torch.optim.Adam(trained, lr=3e-3)
    for _ in range(steps):
        logits = model.decode_train(trg[:, :-1], enc.memory, enc.memory_key_padding_mask)
        loss = torch.nn.functional.cross_entropy(logits.transpose(1, 2), trg[:, 1:],
                                                 ignore_index=vocab.PAD_ID)
        opt.zero_grad()
        loss.backward()
        opt.step()
    checkpoint.export_params_msgpack(model, path)
    return path


def injected_evaluate(harness_mod, seen: list):
    """A stand-in for ``harness_mod.evaluate_molecules`` (either package's
    harness): it appends (the records, the ``sim_kwargs``) of each call to
    ``seen`` and returns results fixed by each record's id, in
    ``harness_mod``'s own classes, with ``harness_mod.summarize``'s summary."""
    import hashlib

    def fake(records, *args, **kwargs):
        seen.append((list(records), kwargs.get("sim_kwargs")))
        results = []
        for r in records:
            h = int(hashlib.sha1(r.sample_id.encode()).hexdigest(), 16)
            cands = [harness_mod.CandidateResult(r.smiles if h % 3 == 0 else "CCO",
                                                 tanimoto=(h % 7) / 7.0, exact=h % 3 == 0),
                     harness_mod.CandidateResult("CCN", tanimoto=(h % 5) / 9.0)]
            results.append(harness_mod.MoleculeResult(target=r.smiles, greedy="CCO",
                                                      greedy_exact=h % 2 == 0,
                                                      candidates=cands))
        return results, harness_mod.summarize(results)
    return fake
