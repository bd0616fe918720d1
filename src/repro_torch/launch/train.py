"""End-to-end training driver: data → step → checkpoint/restart → watchdog.

The counterpart of ``repro/launch/train.py`` on one card: the same loop,
arguments and flags, plus ``device`` (``--device``; ``cuda`` unless the
caller asks for the CPU, and without a card the default raises).  Async
checkpoints off the step path, the straggler watchdog, deterministic data
skip on restart.  ``mesh`` (``--mesh``), the sharded path, belongs to the
port's next slice and raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
      --smoke --steps 20 --device cpu --ckpt-dir CKPT_DIR
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.plan import resolve_device
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.watchdog import Watchdog

MESH_NOT_PORTED = ("the sharded training path (mesh=, --mesh: models/sharding.py, "
                   "moe_apply_shard_map) is the port's next slice; train on one card "
                   "with mesh=None")


def to_device(batch: dict, device) -> dict:
    """A ``SyntheticLMData`` batch as tensors on ``device``."""
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


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
    (the step's one read of the device)."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
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
            print(f"[train] restored step {start} from {ckpt_dir}")

    writer = ckpt.AsyncCheckpointer()
    wd = Watchdog()
    history = []

    # The async writer must land any in-flight checkpoint even when the
    # loop dies mid-run (the restart drill depends on step_N being
    # committed), hence the try/finally around the whole step loop.
    try:
        for step in range(start, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = to_device(data.batch_at(step), dev)
            wd.start_step()
            if compress_grads:
                params, opt_state, comp_state, metrics = step_fn(
                    params, opt_state, batch, comp_state)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            values = torch.stack([v.to(torch.float32) for v in metrics.values()]).tolist()
            stats = wd.end_step()
            metrics = dict(zip(metrics, values))
            metrics.update(step=step, **{k: v for k, v in stats.items() if k != "slow"})
            history.append(metrics)
            if step % log_every == 0:
                print(f"[train] step {step} loss {metrics['loss']:.4f} "
                      f"({stats['step_time']*1e3:.0f} ms)")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                writer.save(ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                            extra={"step": step + 1})
    finally:
        writer.wait()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state},
                  extra={"step": steps})
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
                    help="e.g. '2x2:data,model': the sharded path, not ported yet (raises)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(MESH_NOT_PORTED)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    _, history = train_loop(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
        device=args.device)
    print(f"[train] done: final loss {history[-1]['loss']:.4f} "
          f"(start {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
