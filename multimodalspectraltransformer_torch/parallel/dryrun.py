"""The multi-rank dry run: the counterpart of ``__graft_entry__.dryrun_multichip``.

    python -m multimodalspectraltransformer_torch.parallel.dryrun 8 [--device cuda|cpu]

Starts ``n`` ranks (``parallel/launch.py``, gloo) and runs in each, at small
width (1+1 layers, ``ffn_dim`` 256):

- one train step over a (dcn 2, data n/4, model 2) mesh when ``n % 8 == 0``,
  else (data n/2, model 2) for even ``n`` and (data n, model 1) for odd, with
  tensor parallelism over ``model``: the loss must be finite;
- the sharded device dataset: the batch each rank gathers from its partition
  must train like the same rows composed on the host;
- fan-out decoding over a (data n) mesh, every rank's lanes gathered;
- a harness round over the same 8 molecules, sharded over (data n), equal to
  the one-process run (greedy, candidate sets, mean greedy tanimoto).

It prints one line of the JAX dry run's shape and raises on any failure.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from . import collectives
from ..utils.device import DeviceLike, resolve_device
from .launch import launch
from .mesh import (batch_sharding, data_extent, make_mesh, make_multislice_mesh, rank_shard,
                   shard_for_inference, shard_model)

SMILES = ["CCO", "CC(C)=O", "Cc1ccccc1", "CCN", "CC(N)C(=O)O", "c1ccncc1", "CCOC(C)=O", "CC(O)CC"]


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> str:
    """Run the dry run on ``n_devices`` ranks on ``device`` (CUDA unless
    ``"cpu"`` is asked for; ranks that share one card meet over gloo) and
    return, after printing, its line."""
    kind = resolve_device(device).type
    line = launch("multimodalspectraltransformer_torch.parallel.dryrun:_dryrun_rank", n_devices,
                  args=(n_devices, kind), device=kind, backend="gloo")[0]
    print(line, flush=True)
    return line


def _dryrun_rank(n_devices: int, device: str) -> str:
    from ..data import pipeline as dp
    from ..decode import samplers
    from ..eval import harness
    from ..models import mmt
    from ..sim import factory
    from ..train.state import create_state
    from ..train.step import train_step
    from ..utils.config import DecodeConfig, MMTConfig, ModelConfig, TrainConfig

    # the launcher's init_distributed made this rank's card the current one
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(
        "cpu")
    if n_devices % 8 == 0:
        model_par, data_par = 2, n_devices // 4
        mesh = make_multislice_mesh(2, data=data_par, model=model_par)
    else:
        model_par = 2 if n_devices % 2 == 0 else 1
        mesh = make_mesh(data=n_devices // model_par, model=model_par)
    data_par = data_extent(mesh)
    shard = rank_shard(mesh)
    cfg = MMTConfig(model=ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=256),
                    train=TrainConfig(learning_rate=1e-3))
    batch_size = 2 * data_par
    rows = batch_sharding(mesh, batch_size)

    # one train step with tensor parallelism over `model`
    gen = torch.Generator().manual_seed(1)
    inputs = mmt.dummy_batch(cfg.model, batch_size, device="cpu")
    inputs = inputs._replace(src_1h=torch.rand(inputs.src_1h.shape, generator=gen))
    trg = torch.randint(0, cfg.model.smiles_vocab_size, (batch_size, 64), generator=gen)
    fp = torch.zeros(batch_size, cfg.model.fingerprint_size)
    local = dp.to_device(dp.TrainBatch(mmt.MMTBatch(*(x[rows] for x in inputs)), trg[rows],
                                       fp[rows]), dev)
    model = shard_model(mmt.init_model(cfg.model, 0, dev), shard)
    state, metrics = train_step(cfg, create_state(cfg.train, model), local, seed=2)
    loss = float(metrics.loss)
    if not np.isfinite(loss):
        raise AssertionError(f"train step loss {loss}")

    # the sharded device dataset: each rank's gathered batch trains like the
    # same rows composed on the host
    recs = dp.synthetic_dataset(8 * data_par, seed=4)
    ldr = dp.Loader(recs, cfg.model, batch_size=batch_size, seed=1)
    dd = ldr.device_dataset_sharded(mesh, dev)
    if dd is None:
        raise AssertionError("device_dataset_sharded gave no dataset")
    idx = next(iter(ldr.epoch_row_batches_sharded(0, data_par)))
    got = dp.gather_rows(dd, idx[rows])
    host, _ = ldr._featurize_all(1 << 40)
    Rl = len(ldr._device_kept_smiles) // data_par
    bsl = batch_size // data_par
    global_rows = np.concatenate([d * Rl + idx[d * bsl : (d + 1) * bsl] for d in range(data_par)])
    ref = dp.gather_rows(dp.to_device(host, dev), global_rows[rows])

    def fresh_step(batch):
        m = shard_model(mmt.init_model(cfg.model, 5, dev), shard)
        return float(train_step(cfg, create_state(cfg.train, m), batch, seed=7)[1].loss)

    loss_a, loss_b = fresh_step(got), fresh_step(ref)
    if not np.isclose(loss_a, loss_b, rtol=1e-6, atol=0.0):
        raise AssertionError(f"sharded gather trains otherwise: {loss_a} vs {loss_b}")

    # fan-out decoding sharded over (data n)
    dp_mesh = make_mesh(data=n_devices, model=1)
    dp_shard = rank_shard(dp_mesh)
    rep = mmt.init_model(cfg.model, 0, dev).eval()
    enc = rep.encode(inputs.to(dev))
    p_s, mem_s, kpm_s = shard_for_inference(dp_mesh, rep.state_dict(), enc.memory,
                                            enc.memory_key_padding_mask)
    n_lanes = mem_s.shape[0] * 2
    lane_rows = torch.arange(dp_shard.dp_index * n_lanes, (dp_shard.dp_index + 1) * n_lanes,
                             device=dev)
    dec = samplers.multinomial_decode(p_s, cfg.model, mem_s, kpm_s,
                                      torch.Generator(device=dev).manual_seed(3), 1.0, 8, fanout=2,
                                      device=dev, global_lanes=n_lanes * n_devices,
                                      lane_rows=lane_rows)
    tokens = np.concatenate(collectives.dp_gather_rows([dec.tokens.cpu().numpy()], dp_shard))
    if tokens.shape != (batch_size * 2, 8):
        raise AssertionError(f"fan-out tokens {tokens.shape}")

    # a harness round over the mesh against the one-process run
    records = factory.simulate_records(SMILES, use_default_models=False, device=dev)
    hdcfg = DecodeConfig(max_len=12, fanout=4, multinom_runs=2, max_temp_rounds=1,
                         mw_filter=False)
    run = dict(seed=9, device=dev, sim_kwargs=dict(use_default_models=False))
    ref_res, ref_sum = harness.evaluate_molecules(records, rep, hdcfg, **run)
    sh_res, sh_sum = harness.evaluate_molecules(records, rep, hdcfg, mesh=dp_mesh, **run)
    if [r.greedy for r in ref_res] != [r.greedy for r in sh_res]:
        raise AssertionError("sharded greedy differs from one process")
    cands = lambda res: [sorted(c.smiles for c in r.candidates) for r in res]
    if cands(ref_res) != cands(sh_res):
        raise AssertionError("sharded candidates differ from one process")
    if not np.isclose(ref_sum.greedy_tanimoto, sh_sum.greedy_tanimoto):
        raise AssertionError("sharded greedy tanimoto differs from one process")

    return (f"dryrun_multichip ok: mesh axes={mesh.mesh_dim_names} shape={tuple(mesh.shape)} "
            f"(batch shards={data_par}, tp={model_par}), loss={loss:.4f}, step={state.step}; "
            f"sharded fan-out decode over data={n_devices} ok; "
            f"sharded harness round over {len(ref_res)} molecules == single-device; "
            f"sharded device-dataset gather trains identically to host-composed batch")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="The multi-rank dry run of the port.")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
