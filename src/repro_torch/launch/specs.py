"""Meta-device stand-ins and sharding specs for every dry-run cell: the
counterpart of ``repro/launch/specs.py``.

``step_and_specs(arch, shape, mesh)`` returns (fn, args, specs, policy):
``fn(*args)`` runs the cell's step (a training step, a prefill or encode,
a decode step) on meta tensors, which have shapes and dtypes and no
memory; ``specs`` holds the fitted :class:`P` of every argument on
``mesh`` (a ``DeviceMesh`` or a ``ShapeMesh``: only names and sizes are
read), and ``policy`` is the cell's activation policy.  ``repro`` lowers
the same step with ``jax.jit`` under that policy; the port places the
arguments on a ``DeviceMesh`` (:func:`distribute_args`, as
``train_loop(mesh=...)`` places them) and runs the step under it
(``launch/dryrun.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShapesOnly
from repro_torch.models.sharding import (
    P,
    batch_axes,
    cache_sharding_tree,
    distribute_params,
    make_activation_policy,
    params_sharding_tree,
    placements,
)
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import make_train_step

META = torch.device("meta")

__all__ = ["params_specs", "opt_specs", "batch_specs", "cache_specs", "step_and_specs",
           "distribute_args"]


def params_specs(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors."""
    return init_params(cfg, ShapesOnly())


def opt_specs(params):
    """The optimizer state of a (meta) parameter tree."""
    return init_opt_state(params)


def batch_specs(cfg: ModelConfig, shape_name: str, mesh):
    """(batch of meta tensors, its specs) for a train/prefill batch."""
    spec = SHAPES[shape_name]
    b, l = spec.global_batch, spec.seq_len
    dp = batch_axes(mesh, b)
    i32, f32 = torch.int32, torch.float32
    batch: dict = {"labels": torch.empty((b, l), dtype=i32, device=META)}
    specs: dict = {"labels": P(dp, None)}
    if cfg.frontend_dim:
        batch["tokens"], specs["tokens"] = None, None
        batch["frames"] = torch.empty((b, l, cfg.frontend_dim), dtype=f32, device=META)
        specs["frames"] = P(dp, None, None)
    else:
        batch["tokens"] = torch.empty((b, l), dtype=i32, device=META)
        specs["tokens"] = P(dp, None)
    if cfg.n_cross_layers:
        batch["img"] = torch.empty((b, cfg.vision_seq, cfg.d_model), dtype=f32, device=META)
        specs["img"] = P(dp, None, None)
    return batch, specs


def cache_specs(cfg: ModelConfig, shape_name: str, mesh):
    """(decode cache of meta tensors, its specs): ``cache_sharding_tree``'s
    layout, the KV sequence axis on ``model`` (context-parallel decode)
    where it divides."""
    spec = SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    cache = init_cache(cfg, b, s, device=META)
    return cache, cache_sharding_tree(cache, cfg, mesh, b)


def step_and_specs(arch: str, shape_name: str, mesh, *,
                   opt_cfg: OptimizerConfig | None = None, cfg=None):
    """(fn, args, specs, policy) for one dry-run cell.

    ``cfg`` overrides the registry config (variants: remat policy, chunk
    sizes, moe_impl)."""
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape_name]
    dp = dp_axes(mesh)
    policy = make_activation_policy(mesh, cfg, dp=dp)
    params = params_specs(cfg)
    p_specs = params_sharding_tree(params, cfg, mesh, dp=dp)

    if spec.kind == "train":
        opt_state = opt_specs(params)
        o_specs = {"m": p_specs, "v": p_specs, "step": P()}
        batch, b_specs = batch_specs(cfg, shape_name, mesh)
        return (make_train_step(cfg, opt_cfg or OptimizerConfig()), (params, opt_state, batch),
                (p_specs, o_specs, b_specs), policy)

    if spec.kind == "prefill":
        batch, b_specs = batch_specs(cfg, shape_name, mesh)
        def img_of(batch):
            # The model takes the image in its own dtype, as lm_loss casts it.
            img = batch.get("img")
            return None if img is None else img.to(getattr(torch, cfg.dtype))

        if not cfg.causal:
            # Encoder: "prefill" is the full forward (no cache).
            def encode(params, batch):
                return forward(params, cfg, batch["tokens"], img=img_of(batch),
                               frames=batch.get("frames"))
            return encode, (params, batch), (p_specs, b_specs), policy

        def prefill_step(params, batch):
            return prefill(params, cfg, batch["tokens"], img=img_of(batch),
                           frames=batch.get("frames"))

        return prefill_step, (params, batch), (p_specs, b_specs), policy

    # decode
    cache, c_specs = cache_specs(cfg, shape_name, mesh)
    b = spec.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device=META)
    t_spec = P(batch_axes(mesh, b), None)

    def serve_step(params, token, cache):
        return decode_step(params, cfg, token, cache)

    return serve_step, (params, token, cache), (p_specs, t_spec, c_specs), policy


def distribute_args(args, specs, mesh):
    """A cell's meta arguments as DTensors on the ``DeviceMesh`` ``mesh``,
    placed as ``train_loop(mesh=...)`` places them: the parameters by their
    fitted specs (``distribute_params``), ``m`` and ``v`` zeros like the
    placed parameters and ``step`` a plain scalar (``init_opt_state``), and
    every other tensor (the batch, the token, the cache) by its spec."""
    from torch.distributed.tensor import distribute_tensor

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if x is None:
            return None
        return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)

    params = distribute_params(args[0], specs[0], mesh)
    if isinstance(args[1], dict) and "m" in args[1]:       # a training step's state
        return params, opt_specs(params), place(args[2], specs[2])
    return (params, *(place(a, s) for a, s in zip(args[1:], specs[1:])))
