"""The rank side of ``tests/test_torch_sharded.py``: one gloo group of 4
CPU processes running the port's sharded model stack on a ``(2, 2)``
``("data", "model")`` ``DeviceMesh``.

It imports neither jax nor ``repro``: the parent writes ``repro``'s
weights and its step-0 checkpoint into the group's directory before the
ranks start, and holds what they send back against ``repro``.  One job runs
every case, so DTensor's sharding decisions, made on first sight of each
operation, are made once for the cases that share shapes.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.sharding import use_policy

MESH = (2, 2)
MOE_ARCHS = ("qwen3_moe_30b_a3b", "grok_1_314b")
MOE_TOKENS = (4, 16)            # repro's test_shard_map_moe_matches_gspmd
TRAIN = dict(global_batch=4, seq_len=64)
TRAIN_STEPS, COMPRESSED_STEPS = 4, 2   # then 2 more with compress_grads
DRILL_STEPS, DRILL_EVERY, DRILL_MORE = 4, 2, 2
# lm_loss and its gradients on a mesh, from repro's weights: (arch, mesh).  On
# (2, 2) the SSD (and Hymba's attention) run on each rank's heads; on (1, 4)
# TinyLlama's 4 q heads go one a rank, two ranks sharing each of its 2 kv
# heads (the whole k and v cut to that head, their gradient a partial sum).
LOSS_CASES = (("mamba2_780m", (2, 2)), ("hymba_1_5b", (2, 2)), ("tinyllama_1_1b", (1, 4)))
LOSS_TOKENS = (4, 32)
# More lm_loss cases, (name, arch, mesh): Hymba with its heads whole on model,
# as the published config keeps them (WHOLE_HEADS), on 2 rows of 64 tokens:
# the batch does not cover model, so the SSD splits its 4 chunks of 16 over
# it; TinyLlama's loss with masked labels (-1) and labels in every vocab
# shard, on both meshes; and attention whose heads do not split over model,
# each rank running its block of query rows (RESHAPED): Hymba at d_model 80
# (5 q heads, 1 kv head, its sliding window of 16 kept; its heads whole on
# model, as the published config keeps them), the same through the chunked
# form on 4 rows of 48 (its q chunk of 16 cut to 8, which divides the
# rank's 24 rows; the SSD in chunks of 8), and TinyLlama at
# d_model 96 (6 q heads, 3 kv heads: a rank's 3 q heads cross two kv
# groups).
LOSS_VARIANTS = (("whole_heads", "hymba_1_5b", (2, 2)),
                 ("masked_labels", "tinyllama_1_1b", (2, 2)),
                 ("masked_labels", "tinyllama_1_1b", (1, 4)),
                 ("odd_heads", "hymba_1_5b", (2, 2)),
                 ("odd_heads_chunked", "hymba_1_5b", (2, 2)),
                 ("crossed_kv", "tinyllama_1_1b", (2, 2)))
WHOLE_HEADS = dict(shard_ssm_heads=False, shard_attn_heads=False)
WHOLE_HEADS_TOKENS = (2, 64)
# The variants whose widths differ from their SMOKE config's: their own
# weights, in the group's directory under the case's name.
ODD_HEADS = dict(d_model=80, n_heads=5, n_kv_heads=1, **WHOLE_HEADS)
RESHAPED = {"odd_heads": ODD_HEADS,
            "odd_heads_chunked": dict(ODD_HEADS, attn_chunk_threshold=16, attn_q_chunk=16,
                                      attn_k_chunk=8, ssm_chunk=8),
            "crossed_kv": dict(d_model=96, n_heads=6, n_kv_heads=3)}
CHUNKED_TOKENS = (4, 48)        # odd_heads_chunked's tokens
# prefill and decode_step on the (2, 2) mesh from repro's weights, the KV
# cache's sequence on model: a prompt of 6 into a cache of 16 (8 positions a
# rank), then 4 steps whose slots cross from rank 0's half into rank 1's;
# Mamba-2's state split by heads.
DECODE_ARCHS = ("tinyllama_1_1b", "mamba2_780m")
DECODE = dict(batch=2, prompt=6, max_len=16, steps=4)
# The weights the parent writes under the group's directory, one folder an arch.
WEIGHT_ARCHS = tuple(sorted({a for a, _ in LOSS_CASES} | set(DECODE_ARCHS)))
# One-row microbatches on a (1, 1) mesh: rank r trains ONE_ROW_ARCHS[r].
ONE_ROW_ARCHS = ("tinyllama_1_1b", "qwen3_moe_30b_a3b")
ONE_ROW = dict(global_batch=2, microbatches=2, seq_len=32)
ONE_ROW_STEPS = 2
CLI_ARGS = ["--arch", "tinyllama_1_1b", "--smoke", "--steps", "2", "--global-batch", "4",
            "--seq-len", "64", "--device", "cpu"]


def restore_params(cfg, path):
    """The parameters ``repro`` saved at step 0 under ``params``."""
    from repro_torch.models import init_params
    from repro_torch.train import checkpoint

    target = init_params(cfg, torch.Generator().manual_seed(0))
    return checkpoint.restore(path, 0, {"params": target})[0]["params"]


def whole(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def remat_grads(params, cfg, policy, toks):
    """The largest difference between lm_loss's gradients without remat and
    with remat "full", each backward run on another thread as a card's runs
    on autograd's own (with DTensor's implicit replication, process-wide in
    the card's torch, and no activation policy): the recomputation must see
    the forward's policy."""
    import threading

    from repro_torch.models import lm_loss
    from repro_torch.models.sharding import _implicit_replication
    from repro_torch.train.tree import flatten

    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    batch = {"tokens": toks, "labels": toks}
    grads = {}

    def backward(remat, loss):
        with _implicit_replication():
            grads[remat] = torch.autograd.grad(loss, list(flat.values()))

    for remat in ("none", "full"):
        with use_policy(policy):
            loss, _ = lm_loss(params, dataclasses.replace(cfg, remat=remat), batch)
            worker = threading.Thread(target=backward, args=(remat, loss))
            worker.start()
            worker.join()
    return max(float(np.abs(whole(a) - whole(b)).max())
               for a, b in zip(grads["none"], grads["full"]))


def variant_config(name, arch):
    """``arch``'s SMOKE config as the loss case ``name`` runs it."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke(arch)
    if name == "whole_heads":
        return dataclasses.replace(cfg, **WHOLE_HEADS)
    return dataclasses.replace(cfg, **RESHAPED.get(name, {}))


def on_mesh(arch, tmp, mesh, cfg=None, weights=None):
    """(SMOKE config (or ``cfg``), ``repro``'s weights for ``arch`` (or from
    the folder ``weights``) placed on ``mesh`` as ``train_loop(mesh=...)``
    places them, the activation policy)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models.sharding import make_activation_policy, shard_params

    cfg = cfg or get_smoke(arch)
    params = shard_params(restore_params(cfg, os.path.join(tmp, weights or arch)), cfg, mesh)
    return cfg, params, make_activation_policy(mesh, cfg, dp=dp_axes(mesh))


class Shapes(TorchDispatchMode):
    """The shape of every plain tensor that an operation makes on this rank
    (DTensor's operations are seen as the local operations they run)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.seen.update(tuple(t.shape) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


def tokens_on(a, mesh):
    """Token ids ``a`` (numpy, (B, L)) on ``mesh``, the batch split on the
    data axes."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models.sharding import P, placements

    return distribute_tensor(torch.from_numpy(a), mesh, placements(P(dp_axes(mesh), None), mesh),
                             src_data_rank=None)


def loss_and_grads(arch, tmp, mesh, case=None):
    """lm_loss of ``arch`` on ``repro``'s weights and tokens on ``mesh``, and
    its gradients, whole, by leaf path; ``case`` one of LOSS_VARIANTS'
    names, whose tokens and labels the parent wrote as ``{case}_tokens.npy``
    and ``{case}_labels.npy``.  A RESHAPED case also returns the shapes that
    its forward and backward made on this rank."""
    from repro_torch.models import lm_loss
    from repro_torch.train.tree import flatten, placed_like

    cfg, params, policy = on_mesh(arch, tmp, mesh, variant_config(case, arch),
                                  case if case in RESHAPED else None)
    name = case or "loss"
    toks = tokens_on(np.load(os.path.join(tmp, f"{name}_tokens.npy")), mesh)
    labels = toks if case is None else tokens_on(np.load(os.path.join(tmp, f"{name}_labels.npy")),
                                                 mesh)
    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    with use_policy(policy), Shapes() as shapes:
        loss, _ = lm_loss(params, cfg, {"tokens": toks, "labels": labels})
        grads = torch.autograd.grad(loss, list(flat.values()))
    out = (float(whole(loss)), {k: whole(placed_like(g, flat[k])) for k, g in zip(flat, grads)})
    return out + (sorted(shapes.seen),) if case in RESHAPED else out


def decode_logits(arch, tmp, mesh):
    """``prefill`` of ``repro``'s prompt, then a ``decode_step`` for each of
    ``repro``'s fed tokens, on ``mesh``: each call's logits, whole, and the
    placements of the last cache's leaves."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.train.tree import flatten

    cfg, params, policy = on_mesh(arch, tmp, mesh)
    prompt = tokens_on(np.load(os.path.join(tmp, "prompt.npy")), mesh)
    with use_policy(policy), torch.no_grad():
        logits, cache = prefill(params, cfg, prompt, max_len=DECODE["max_len"])
        out = [whole(logits)]
        for tok in np.load(os.path.join(tmp, "feed.npy")):
            logits, cache = decode_step(params, cfg, tokens_on(tok, mesh), cache)
            out.append(whole(logits))
    return out, {k: str(getattr(v, "placements", None)) for k, v in flatten(cache).items()}


def counted_step(mesh, device) -> dict:
    """TinyLlama SMOKE's training step on ``mesh`` (TRAIN's batch), placed
    as ``train_loop(mesh=...)`` places it, run once under the roofline
    analysis' counter: its totals (collective calls and bytes by kind,
    FLOPs, bytes).  ``device`` "meta" on a fake group is the analysis' own
    run; "cpu" on the gloo group, the step counted for real."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.models.layers import ShapesOnly
    from repro_torch.models.sharding import make_activation_policy, shard_params
    from repro_torch.roofline.analysis import count_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    cfg = get_smoke("tinyllama_1_1b")
    gen = ShapesOnly() if device == "meta" else torch.Generator().manual_seed(0)
    params = shard_params(init_params(cfg, gen), cfg, mesh)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                           global_batch=TRAIN["global_batch"], seed=0)
    args = (params, init_opt_state(params), to_device(data.batch_at(0), torch.device(device), mesh))
    with use_policy(make_activation_policy(mesh, cfg, dp=dp_axes(mesh))):
        return count_step(make_train_step(cfg, OptimizerConfig()), args)


def job_stack(rank, world, tmp):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import dp_axes, make_mesh, make_two_level_mesh
    from repro_torch.models import forward, init_params
    from repro_torch.models.sharding import (
        P,
        make_activation_policy,
        placements,
        shard_params,
    )
    from repro_torch.train import checkpoint
    from repro_torch.train.tree import flatten

    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    dp = dp_axes(mesh)
    two = make_two_level_mesh(world, device="cpu")
    out = {"two_level": (tuple(two.mesh_dim_names), tuple(two.shape),
                         list(two.get_coordinate()))}

    # The MoE's two engines on repro's weights, logits gathered.
    for arch in MOE_ARCHS:
        cfg = get_smoke(arch)
        params = restore_params(cfg, os.path.join(tmp, arch))
        params = shard_params(params, cfg, mesh)
        toks = torch.from_numpy(np.load(os.path.join(tmp, f"{arch}_tokens.npy")))
        toks = distribute_tensor(toks, mesh, placements(P(dp, None), mesh),
                                 src_data_rank=None)
        policy = make_activation_policy(mesh, cfg, dp=dp)
        for impl in ("shard_map", "gspmd"):
            with use_policy(policy), torch.no_grad():
                logits, aux = forward(params, dataclasses.replace(cfg, moe_impl=impl), toks)
            out[(arch, impl)] = (whole(logits), float(whole(aux)))
        out[(arch, "remat")] = remat_grads(params, cfg, policy, toks)

    # train_loop on the mesh from repro's step 0: TRAIN_STEPS steps, then
    # COMPRESSED_STEPS more with compress_grads, resumed from the checkpoint.
    cfg = get_smoke("tinyllama_1_1b")
    d = os.path.join(tmp, "tinyllama")
    _, first = cli.train_loop(cfg, steps=TRAIN_STEPS, mesh=mesh, ckpt_dir=d, ckpt_every=100,
                              device="cpu", **TRAIN)
    _, more = cli.train_loop(cfg, steps=TRAIN_STEPS + COMPRESSED_STEPS, mesh=mesh,
                             ckpt_dir=d, compress_grads=True, device="cpu", **TRAIN)
    out["train"] = first + more

    # lm_loss and its gradients, prefill and decode on the meshes, from
    # repro's weights.
    meshes = {MESH: mesh, (1, 4): DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                                             mesh_dim_names=("data", "model"))}
    for arch, shape in LOSS_CASES:
        out[("loss", arch, shape)] = loss_and_grads(arch, tmp, meshes[shape])
    for case, arch, shape in LOSS_VARIANTS:
        out[("loss", case, shape)] = loss_and_grads(arch, tmp, meshes[shape], case)
    for arch in DECODE_ARCHS:
        out[("decode", arch)] = decode_logits(arch, tmp, mesh)

    # One step under the roofline analysis' counter, on the real group.
    out["counted"] = counted_step(mesh, "cpu")

    # The CLI under the same group, one call a rank.
    out["cli"] = cli.main(CLI_ARGS + ["--mesh", "2x2:data,model"])

    # The elastic drill: StableLM on (2, 2), checkpointed at step DRILL_STEPS;
    # ranks 0-1 restore it onto (1, 2) and train on.
    cfg = get_smoke("stablelm_1_6b")
    d = os.path.join(tmp, "drill")
    params, _ = cli.train_loop(cfg, steps=DRILL_STEPS, mesh=mesh, ckpt_dir=d,
                               ckpt_every=DRILL_EVERY, device="cpu", **TRAIN)
    saved = {k: whole(v) for k, v in flatten(params).items()}
    small = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
    if rank < 2:
        target = init_params(cfg, torch.Generator().manual_seed(1))
        target = shard_params(target, cfg, small)
        restored, extra = checkpoint.restore(d, checkpoint.latest_step(d),
                                             {"params": target})
        got = {k: whole(v) for k, v in flatten(restored["params"]).items()}
        out["drill_equal"] = (sorted(got) == sorted(saved)
                              and all(np.array_equal(got[k], saved[k]) for k in saved))
        out["drill_placements"] = sorted({str(v.placements) for v in
                                          flatten(restored["params"]).values()})
        _, resumed = cli.train_loop(cfg, steps=DRILL_STEPS + DRILL_MORE, mesh=small,
                                    ckpt_dir=d, ckpt_every=100, device="cpu", **TRAIN)
        out["drill"] = (extra, resumed)

    # train_loop on a (1, 1) mesh of its own a rank, from repro's step 0, in
    # microbatches of one row; every rank builds every rank's mesh.
    singles = [DeviceMesh("cpu", torch.tensor([[r]]), mesh_dim_names=("data", "model"))
               for r in range(world)]
    if rank < len(ONE_ROW_ARCHS):
        arch = ONE_ROW_ARCHS[rank]
        _, hist = cli.train_loop(get_smoke(arch), steps=ONE_ROW_STEPS, mesh=singles[rank],
                                 ckpt_dir=os.path.join(tmp, f"one_row_{arch}"),
                                 ckpt_every=100, device="cpu", **ONE_ROW)
        out["one_row"] = (arch, hist)
    return out


JOBS = {"stack": job_stack}
