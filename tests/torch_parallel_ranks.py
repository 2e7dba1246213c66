"""What the ranks of the parallel tests run (``parallel/launch.py`` starts
them). A helper module, not a test module: the ranks import it, and it imports
neither JAX nor the JAX package, nor the tests' conftest. Every function
builds its mesh from ``layout`` = (slices or None, data, model) and returns
numpy arrays and plain values; ``jobs`` runs several in one launch, since
starting the ranks costs more than most jobs."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from multimodalspectraltransformer_torch import parallel
from multimodalspectraltransformer_torch.data import pipeline as dp
from multimodalspectraltransformer_torch.models import mmt
from multimodalspectraltransformer_torch.parallel import collectives
from multimodalspectraltransformer_torch.parallel.mesh import gather_tp
from multimodalspectraltransformer_torch.train import loop, state as tstate, step as tstep


def jobs(todo: list) -> list:
    """Run each ``(function name, args, kwargs)`` of ``todo`` in turn."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in todo]


def make(layout):
    slices, data, model = layout
    if slices is None:
        return parallel.make_mesh(data=data, model=model)
    return parallel.make_multislice_mesh(slices, data=data, model=model)


def _model(cfg, params: dict) -> mmt.MultimodalTransformer:
    model = mmt.MultimodalTransformer(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _rows(batch: dp.TrainBatch, rows: slice) -> dp.TrainBatch:
    t = lambda x: torch.as_tensor(np.asarray(x)[rows])
    return dp.TrainBatch(mmt.MMTBatch(*(t(x) for x in batch.inputs)), t(batch.trg_tokens),
                         t(batch.trg_fp))


def mesh_facts(layout) -> dict:
    """The mesh's names and shape, this rank's shard, its rows of an 8-row
    batch, and a two-stage data-parallel sum against a flat one."""
    mesh = make(layout)
    shard = parallel.rank_shard(mesh)
    g = torch.Generator().manual_seed(dist.get_rank())
    x = torch.randn(1000, generator=g, dtype=torch.float32)
    flat = collectives.all_reduce_(x.clone())  # every rank, all model ranks included
    staged = collectives.dp_all_reduce_(x.clone(), shard)
    model_sum = (collectives.all_reduce_(staged.clone(), shard.model_group)
                 if shard.model_group is not None else staged)
    return dict(names=mesh.mesh_dim_names, shape=tuple(mesh.shape), extent=parallel.data_extent(mesh),
                coord=mesh.get_coordinate(), dp_index=shard.dp_index, tp_rank=shard.tp_rank,
                rows=parallel.batch_sharding(mesh, 8), flat=flat.numpy(),
                two_stage=model_sum.numpy(),
                gathered=collectives.all_gather_object(dist.get_rank()))


def step(layout, cfg, params: dict, batch, seed: int = 0, device: str = "cpu") -> dict:
    """One ``train_step`` on this rank's rows from ``params`` (on this rank's
    card with ``device="cuda"``): the global metrics and, on rank 0, the whole
    gradients and updated parameters."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
    mesh = make(layout)
    shard = parallel.rank_shard(mesh)
    model = parallel.shard_model(_model(cfg.model, params).to(dev), shard)
    state = tstate.create_state(cfg.train, model)
    B = np.asarray(batch.trg_tokens).shape[0]
    local = dp.to_device(_rows(batch, shard.rows(B // shard.dp_size)), dev)
    state, m = tstep.train_step(cfg, state, local, seed)
    out = dict(loss=float(m.loss), smi=float(m.smi_loss), fp=float(m.fp_loss),
               acc=float(m.token_accuracy), gnorm=float(m.grad_norm))
    grads = {n: gather_tp(n, p.grad, shard).cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    after = {k: v.cpu().numpy() for k, v in parallel.gather_state_dict(model).items()}
    if dist.get_rank() == 0:
        out.update(grads=grads, params=after)
    return out


def fail_on(rank: int) -> None:
    """Raise in rank ``rank`` (the launcher's error path)."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} gives up")
    dist.barrier()


def training(layout, cfg, records, val_records, params: dict, batch_size: int, max_steps: int,
             checkpoint_dir=None, metrics_path=None, device_data=False) -> dict:
    """``run_training`` under the mesh; rank 0 also returns the whole
    parameters."""
    mesh = make(layout)
    res = loop.run_training(
        cfg, dp.Loader(records, cfg.model, batch_size=batch_size, seed=1),
        dp.Loader(val_records, cfg.model, batch_size=batch_size, seed=2),
        init_params={k: torch.from_numpy(v) for k, v in params.items()}, mesh=mesh,
        checkpoint_dir=checkpoint_dir, metrics_path=metrics_path, max_steps=max_steps,
        device_data=device_data, device="cpu", gen_metrics_every=2)
    out = dict(history=res.metrics.history, train_loss=res.train_loss, val_loss=res.val_loss,
               steps=res.steps, plateau=(float(res.state.plateau.best), res.state.plateau.bad_count,
                                         float(res.state.plateau.scale)))
    full = parallel.gather_state_dict(res.state.model)
    if dist.get_rank() == 0:
        out["params"] = {k: v.numpy() for k, v in full.items()}
    return out


def training_crash(layout, cfg, records, params: dict, checkpoint_dir: str) -> dict:
    """``run_training`` under the mesh with a step that raises on every rank
    at the second step: what rank 0 printed, and the files it left."""
    import contextlib
    import io

    calls = [0]
    real = loop.train_step

    def failing(*a, **k):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("step fails on purpose")
        return real(*a, **k)

    out = io.StringIO()
    loop.train_step = failing
    try:
        with contextlib.redirect_stdout(out):
            loop.run_training(cfg, dp.Loader(records, cfg.model, batch_size=8, seed=1),
                              init_params={k: torch.from_numpy(v) for k, v in params.items()},
                              mesh=make(layout), checkpoint_dir=checkpoint_dir, max_steps=3,
                              device_data=False, device="cpu")
        raise AssertionError("run_training did not raise")
    except RuntimeError as e:
        if "on purpose" not in str(e):
            raise
    finally:
        loop.train_step = real
    dist.barrier()
    return dict(printed=out.getvalue(), files=sorted(os.listdir(checkpoint_dir)))


def fanout(layout, cfg, params: dict, memory, kpm, seed: int, max_len: int, F: int) -> dict:
    """``multinomial_decode`` of this rank's rows with the global Gumbel rows,
    and ``greedy_decode``, gathered in order."""
    from multimodalspectraltransformer_torch.decode import samplers

    mesh = make(layout)
    p, mem, mask = parallel.shard_for_inference(
        mesh, {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(memory),
        torch.from_numpy(kpm))
    shard = parallel.rank_shard(mesh)
    n = mem.shape[0] * F
    rows = torch.arange(shard.dp_index * n, (shard.dp_index + 1) * n)
    gen = torch.Generator().manual_seed(seed)
    mn = samplers.multinomial_decode(p, cfg, mem, mask, gen, 1.0, max_len, fanout=F,
                                     device="cpu", global_lanes=n * shard.dp_size, lane_rows=rows)
    greedy = samplers.greedy_decode(p, cfg, mem, mask, 1.0, max_len, device="cpu")
    return dict(mn=np.concatenate(collectives.dp_gather_rows([mn.tokens.numpy()], shard)),
                greedy=np.concatenate(collectives.dp_gather_rows([greedy.tokens.numpy()], shard)))


def evaluate(layout, cfg, params, records, dcfg, seed: int, **kw) -> dict:
    """``evaluate_molecules(mesh=...)`` with ``params`` (a state dict, or the
    path of a checkpoint): every rank's results and summary."""
    from multimodalspectraltransformer_torch.eval import harness

    mesh = make(layout)
    model = mmt.load_model(params, cfg, "cpu") if isinstance(params, str) else _model(cfg, params)
    results, summary = harness.evaluate_molecules(
        records, model, dcfg, seed=seed, mesh=mesh, device="cpu",
        sim_kwargs=dict(use_default_models=False), **kw)
    return dict(results=results, summary=summary)


def sharded_dataset(layout, cfg, records, batch_size: int, epoch: int) -> dict:
    """The rank's partition, its rows of the first batches of an epoch, and the
    batches' index arrays."""
    mesh = make(layout)
    shard = parallel.rank_shard(mesh)
    ldr = dp.Loader(records, cfg, batch_size=batch_size, seed=1)
    dd = ldr.device_dataset_sharded(mesh, "cpu")
    n = parallel.data_extent(mesh)
    idxs = list(ldr.epoch_row_batches_sharded(epoch, n))
    rows = shard.rows(batch_size // n)
    got = [dp.gather_rows(dd, idx[rows]) for idx in idxs]
    return dict(idx=idxs, kept=ldr._device_kept_smiles, part_trg=dd.trg_tokens.numpy(),
                trg=[b.trg_tokens.numpy() for b in got], src_1h=[b.inputs.src_1h.numpy() for b in got])
