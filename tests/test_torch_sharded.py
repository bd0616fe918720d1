"""The sharded model stack on one gloo group of 4 CPU ranks, a ``(2, 2)``
``("data", "model")`` ``DeviceMesh``, held against ``repro``'s
single-device results (``repro``'s own mesh tests of this stack fail here
on jax 0.9, ROADMAP.md §3).

The group (``_sharded_ranks.py``) runs, from ``repro``'s weights and
checkpoints: the MoE's ``shard_map`` and ``gspmd`` engines on the
qwen3-moe (experts on ``model``) and grok (d_ff on ``model``) SMOKE
configs; TinyLlama's ``train_loop`` from ``repro``'s step 0, 4 steps and
2 more with ``compress_grads``; the ``--mesh`` CLI on each rank; and
StableLM's elastic drill from ``(2, 2)`` onto ``(1, 2)``.  The parent
computes ``repro``'s references while the ranks run.
"""
from __future__ import annotations

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

import _shard_map_ranks as group
import _sharded_ranks as ranks
import repro.configs as jcfgs
import repro.launch.train as jtrain
import repro.models.transformer as jt
import repro.train.checkpoint as jckpt
import repro_torch.launch.train as ttrain

MOE_TOL = 2e-4                  # repro's tolerance between the two engines
TRAIN_RTOL = 1e-5
GROUP_LIMIT_S = 300             # the whole job, under a loaded suite


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The parent's references on one thread, as each rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _repro_train(start, d, compress):
    """repro's two train_loop calls of the rank job, single device, from the
    step-0 checkpoint in ``start`` (copied to ``d``)."""
    cfg = jcfgs.get_smoke("tinyllama_1_1b")
    shutil.copytree(start, d)
    _, first = jtrain.train_loop(cfg, steps=ranks.TRAIN_STEPS, ckpt_dir=d, ckpt_every=100,
                                 **ranks.TRAIN)
    _, more = jtrain.train_loop(cfg, steps=ranks.TRAIN_STEPS + ranks.COMPRESSED_STEPS,
                                ckpt_dir=d, compress_grads=compress, **ranks.TRAIN)
    return first + more


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """(what each rank sent back, repro's references)."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref = {}
    for i, arch in enumerate(ranks.MOE_ARCHS):
        cfg = jcfgs.get_smoke(arch)
        params = jt.init_params(cfg, jax.random.PRNGKey(i))
        jckpt.save(str(tmp / arch), 0, {"params": params})
        toks = jax.random.randint(jax.random.PRNGKey(10 + i), ranks.MOE_TOKENS, 0,
                                  cfg.vocab_size)
        np.save(tmp / f"{arch}_tokens.npy", np.asarray(toks))
        ref[arch] = np.asarray(jt.forward(params, cfg, toks)[0])
    start = str(tmp / "repro_start")
    jtrain.train_loop(jcfgs.get_smoke("tinyllama_1_1b"), steps=0, ckpt_dir=start,
                      **ranks.TRAIN)
    shutil.copytree(start, tmp / "tinyllama")
    handle = group.start_group(tmp, 4, "stack", str(tmp), module="_sharded_ranks")
    ref["train"] = _repro_train(start, str(tmp / "repro_train"), True)
    ref["cli"] = ttrain.main(ranks.CLI_ARGS)
    outs = group.join_group(handle, GROUP_LIMIT_S)
    return outs, ref, tmp


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
def test_moe_engines_agree_with_repro(stack, arch):
    """shard_map and gspmd forward on the mesh, from repro's weights: the
    same logits on every rank, within 2e-4 of each other and of repro's
    single-device forward (dropless SMOKE configs: capacity_factor E/k)."""
    outs, ref, _ = stack
    sm, gs = outs[0][(arch, "shard_map")][0], outs[0][(arch, "gspmd")][0]
    for o in outs[1:]:
        for impl in ("shard_map", "gspmd"):
            np.testing.assert_array_equal(o[(arch, impl)][0], outs[0][(arch, impl)][0])
    np.testing.assert_allclose(sm, gs, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(sm, ref[arch], rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(gs, ref[arch], rtol=MOE_TOL, atol=MOE_TOL)
    # The aux loss: gspmd's is the global one; shard_map's the mean of each
    # rank's own (a finite number, its own definition).
    assert all(np.isfinite(o[(arch, "shard_map")][1]) for o in outs)


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
def test_remat_recomputes_on_another_thread(stack, arch):
    """lm_loss's gradients on the mesh with remat "full", the backward run
    on another thread (a card's runs on autograd's own), equal those
    without remat: the recomputation sees the forward's activation policy
    (without it the shard_map MoE recomputes as gspmd, on other shapes)."""
    outs, _, _ = stack
    for o in outs:
        assert o[(arch, "remat")] <= 1e-6


def test_sharded_train_follows_repro(stack):
    """TinyLlama's train_loop on (2, 2) from repro's step 0: every step's loss
    within 1e-5 relative of repro's single-device run (the last two with
    compress_grads, resumed from the mesh's checkpoint), lr equal, every
    rank the same history; the loss falls."""
    outs, ref, _ = stack
    want = ref["train"]
    for o in outs:
        got = o["train"]
        assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(6))
        np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want],
                                   rtol=TRAIN_RTOL)
        np.testing.assert_allclose([h["grad_norm"] for h in got],
                                   [h["grad_norm"] for h in want], rtol=1e-4)
        np.testing.assert_allclose([h["lr"] for h in got], [h["lr"] for h in want],
                                   rtol=1e-6)
        assert [h["loss"] for h in got] == [h["loss"] for h in outs[0]["train"]]
    assert want[3]["loss"] < want[0]["loss"]


def test_mesh_checkpoint_restores_in_repro(stack):
    """The mesh's last checkpoint (written by the mesh's first rank, every
    leaf gathered whole) is repro's layout: repro restores it."""
    _, _, tmp = stack
    d = str(tmp / "tinyllama")
    step = jckpt.latest_step(d)
    assert step == ranks.TRAIN_STEPS + ranks.COMPRESSED_STEPS
    cfg = jcfgs.get_smoke("tinyllama_1_1b")
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    restored, extra = jckpt.restore(d, step, {"params": params})
    assert extra == {"step": step}
    assert jax.tree.structure(restored["params"]) == jax.tree.structure(params)


def test_elastic_restore_onto_smaller_mesh(stack):
    """repro's drill: StableLM checkpointed on (2, 2) at step 4, restored on
    ranks 0-1 as (1, 2): the parameters bit-equal to those saved, laid out
    on the smaller mesh; training resumes at step 4, not from scratch."""
    outs, _, _ = stack
    for o in outs[:2]:
        extra, resumed = o["drill"]
        assert o["drill_equal"]
        assert any("Shard" in p for p in o["drill_placements"])
        assert extra == {"step": ranks.DRILL_STEPS}
        assert [h["step"] for h in resumed] == [4, 5]
        assert all(np.isfinite(h["loss"]) for h in resumed)
    assert [h["loss"] for h in outs[0]["drill"][1]] == [h["loss"] for h in outs[1]["drill"][1]]
    assert all("drill" not in o for o in outs[2:])


def test_two_level_mesh(stack):
    """``make_two_level_mesh`` on the group: repro's (node, local) names
    over ``factor_parts``' split, every rank at its place."""
    outs, _, _ = stack
    assert [o["two_level"] for o in outs] == [(("node", "local"), (2, 2), [r // 2, r % 2])
                                              for r in range(4)]


def test_mesh_cli_on_each_rank(stack):
    """``--mesh 2x2:data,model`` through ``main(argv)`` on each rank: every
    rank the same history, within 1e-5 of the single-device CLI's."""
    outs, ref, _ = stack
    for o in outs:
        np.testing.assert_allclose([h["loss"] for h in o["cli"]],
                                   [h["loss"] for h in ref["cli"]], rtol=TRAIN_RTOL)
        assert [h["step"] for h in o["cli"]] == [0, 1]


def test_shape_mesh_and_mesh_arguments():
    """A shape-only mesh's names and sizes; a mesh whose shape and axes
    differ in length refuses to build."""
    from repro_torch.launch.mesh import ShapeMesh, axis_sizes, dp_axes

    m = ShapeMesh(("pod", "data", "model"), (2, 4, 8))
    assert axis_sizes(m) == {"pod": 2, "data": 4, "model": 8}
    assert dp_axes(m) == ("pod", "data")
    assert dataclasses.is_dataclass(m)
    with pytest.raises(ValueError, match="differ in length"):
        from repro_torch.launch.mesh import make_mesh
        make_mesh((2, 2), ("data",), device="cpu")
