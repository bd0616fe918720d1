"""End-to-end training driver: data → step → checkpoint/restart → watchdog.

The counterpart of ``repro/launch/train.py``: the same loop, arguments and
flags, plus ``device`` (``--device``; ``cuda`` unless the caller asks for
the CPU, and without a card the default raises).  Async checkpoints off
the step path, the straggler watchdog, deterministic data skip on restart.

``mesh`` (a ``DeviceMesh``, ``launch/mesh.py``) is the sharded path, one
process per rank of the mesh: the activation policy, the parameters and
``m``/``v`` distributed by the fitted sharding rules, each batch as
``P(dp, None)``, checkpoints gathered to the mesh's first rank, which
writes them and logs.  A restore distributes the checkpoint onto the
current mesh, whatever mesh wrote it (the elastic restore).  ``--mesh
'2x2:data,model'`` runs it under ``torchrun`` (one process per card; gloo
with ``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
      --smoke --steps 20 --device cpu --ckpt-dir CKPT_DIR
  PYTHONPATH=src torchrun --nproc-per-node=4 -m repro_torch.launch.train \
      --arch tinyllama_1_1b --smoke --steps 20 --mesh 2x2:data,model
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.plan import resolve_device
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import dp_axes, leads, make_mesh
from repro_torch.models.sharding import (
    P,
    make_activation_policy,
    placements,
    shard_params,
    use_policy,
)
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import whole
from repro_torch.train.watchdog import Watchdog


def to_device(batch: dict, device, mesh=None) -> dict:
    """A ``SyntheticLMData`` batch as tensors on ``device``; with a mesh,
    each as a DTensor split on its leading (batch) axis over the mesh's
    data-parallel axes, ``P(dp, None)``.  Every rank draws the same batch."""
    out = {k: None if v is None else torch.from_numpy(v).to(device)
           for k, v in batch.items()}
    if mesh is None:
        return out
    from torch.distributed.tensor import distribute_tensor

    dp = dp_axes(mesh)
    return {k: None if v is None else distribute_tensor(
        v, mesh, placements(P(dp, *[None] * (v.ndim - 1)), mesh), src_data_rank=None)
        for k, v in out.items()}


def train_loop(
    cfg,
    *,
    steps: int,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    mesh=None,
    microbatches: int = 1,
    compress_grads: bool = False,
    seed: int = 0,
    log_every: int = 10,
    fail_at_step: int | None = None,   # fault-injection hook (tests)
    device="cuda",
):
    """Returns (params, metrics_history). Restartable from ckpt_dir.

    A step's ``step_time`` runs from its start to its metrics on the host
    (the step's one read of the device).  With ``mesh``, every rank of the
    mesh calls this with the same arguments; ``device`` is the mesh's device
    type."""
    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(total_steps=max(steps, 2), warmup_steps=max(steps // 10, 1))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              compress_grads=compress_grads)

    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, frontend_dim=cfg.frontend_dim,
        vision_seq=cfg.vision_seq if cfg.n_cross_layers else 0,
        d_model=cfg.d_model)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    policy, leader = None, leads(mesh)
    if mesh is not None:
        policy = make_activation_policy(mesh, cfg, dp=dp_axes(mesh))
        params = shard_params(params, cfg, mesh)
    # m and v zeros like the parameters: sharded like them on a mesh.
    opt_state = init_opt_state(params)
    comp_state = compression.init_state(params) if compress_grads else None

    start = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state_tree = {"params": params, "opt": opt_state}
            restored, extra = ckpt.restore(ckpt_dir, last, state_tree)
            params, opt_state = restored["params"], restored["opt"]
            start = int(extra.get("step", last))
            if leader:
                print(f"[train] restored step {start} from {ckpt_dir}")

    writer = ckpt.AsyncCheckpointer()
    wd = Watchdog()
    history = []

    # The async writer must land any in-flight checkpoint even when the
    # loop dies mid-run (the restart drill depends on step_N being
    # committed), hence the try/finally around the whole step loop.  On a
    # mesh the ranks then meet, so that no rank reads the directory before
    # the writer has committed.
    try:
        with use_policy(policy):
            for step in range(start, steps):
                if fail_at_step is not None and step == fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = to_device(data.batch_at(step), dev, mesh)
                wd.start_step()
                if compress_grads:
                    params, opt_state, comp_state, metrics = step_fn(
                        params, opt_state, batch, comp_state)
                else:
                    params, opt_state, metrics = step_fn(params, opt_state, batch)
                values = torch.stack([whole(v).to(torch.float32)
                                      for v in metrics.values()]).tolist()
                stats = wd.end_step()
                metrics = dict(zip(metrics, values))
                metrics.update(step=step, **{k: v for k, v in stats.items() if k != "slow"})
                history.append(metrics)
                if step % log_every == 0 and leader:
                    print(f"[train] step {step} loss {metrics['loss']:.4f} "
                          f"({stats['step_time']*1e3:.0f} ms)")
                if ckpt_dir and (step + 1) % ckpt_every == 0:
                    writer.save(ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                                extra={"step": step + 1})
    finally:
        writer.wait()
        if mesh is not None:
            ckpt.mesh_barrier(mesh)
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state},
                  extra={"step": steps})
        if mesh is not None:
            ckpt.mesh_barrier(mesh)
    return params, history


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x2:data,model': one process per rank, as torchrun "
                         "starts them (needs that many)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh:
        dev = resolve_device(args.device)
        shape_s, axes_s = args.mesh.split(":")
        mesh = make_mesh(tuple(map(int, shape_s.split("x"))), tuple(axes_s.split(",")),
                         device=dev.type)
    _, history = train_loop(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir, mesh=mesh,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
        device=args.device)
    if leads(mesh):
        print(f"[train] done: final loss {history[-1]['loss']:.4f} "
              f"(start {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
