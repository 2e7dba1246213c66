#!/usr/bin/env python3
"""Explainability: token-probability-colored molecule depictions, on the card.

The port's counterpart of ``examples/03_explainability.py``: decode with
per-token probabilities, map token positions onto atoms and render an SVG
whose atom highlights show the model's confidence. The model is drawn from
seed 0 unless ``params`` (a state dict) is given. Runs on the card unless
``main(..., device="cpu")``.

Run: python3 examples/torch_03_explainability.py [out.svg]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.chem.smiles import parse_smiles  # noqa: E402
from multimodalspectraltransformer_torch.chem.tokenizer import tokenize_smiles  # noqa: E402
from multimodalspectraltransformer_torch.data import pipeline as dp  # noqa: E402
from multimodalspectraltransformer_torch.decode import samplers  # noqa: E402
from multimodalspectraltransformer_torch.models import mmt  # noqa: E402
from multimodalspectraltransformer_torch.serve import svg  # noqa: E402
from multimodalspectraltransformer_torch.utils import vocab  # noqa: E402
from multimodalspectraltransformer_torch.utils.config import ModelConfig  # noqa: E402
from multimodalspectraltransformer_torch.utils.device import resolve_device  # noqa: E402

ATOM_TOKENS = set("BCNOPSFI") | {"Cl", "Br", "c", "n", "o", "s", "p", "b"}
MCFG = ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=128)


def token_probs_to_atom_values(smiles: str, probs: list) -> list:
    """Map per-token probabilities onto heavy atoms (non-atom tokens skipped)."""
    vals = []
    for tok, p in zip(tokenize_smiles(smiles), probs):
        if tok in ATOM_TOKENS or (tok.startswith("[") and tok.endswith("]")):
            vals.append(float(p))
    return vals


def main(out_path: str = "colored_molecule.svg", device=None, params=None) -> dict:
    """Decode, color and write the SVG; returns the target, the generated
    SMILES and the atom values."""
    dev = resolve_device(device)
    model = (mmt.model_from_state_dict(params, MCFG, dev) if params is not None
             else mmt.init_model(MCFG, 0, dev))

    rec = dp.synthetic_dataset(1, seed=3)[0]
    feat = dp.featurize(rec, MCFG)
    tb = dp.collate([feat])
    enc = model.encode(mmt.MMTBatch(*tb.inputs).to(dev))
    res = samplers.greedy_decode(model.state_dict(), MCFG, enc.memory,
                                 enc.memory_key_padding_mask, 1.0, 48, device=dev)

    gen = vocab.ids_to_smiles(res.tokens.cpu().numpy()[0])
    probs = res.token_probs.float().cpu().numpy()[0].tolist()
    target = feat["smiles"]
    print("target:", target)
    print("generated:", gen or "(invalid)")

    # color the *target* molecule by the per-token confidence so the
    # depiction always renders (untrained models generate junk)
    vals = token_probs_to_atom_values(target, probs)
    mol = parse_smiles(target)
    vals += [0.5] * (mol.num_atoms - len(vals))
    vals = vals[: mol.num_atoms]
    with open(out_path, "w") as f:
        f.write(svg.mol_to_svg(target, atom_values=vals, title=target))
    print("wrote", out_path)
    return {"target": target, "generated": gen, "atom_values": vals}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "colored_molecule.svg")
