"""The sharded model stack on one gloo group of 4 CPU ranks, a ``(2, 2)``
``("data", "model")`` ``DeviceMesh``, held against ``repro``'s
single-device results (``repro``'s own mesh tests of this stack fail here
on jax 0.9, ROADMAP.md §3).

The group (``_sharded_ranks.py``) runs, from ``repro``'s weights and
checkpoints: the MoE's ``shard_map`` and ``gspmd`` engines on the
qwen3-moe (experts on ``model``) and grok (d_ff on ``model``) SMOKE
configs; TinyLlama's ``train_loop`` from ``repro``'s step 0, 4 steps and
2 more with ``compress_grads``; the ``--mesh`` CLI on each rank;
StableLM's elastic drill from ``(2, 2)`` onto ``(1, 2)``; TinyLlama's
and Qwen3-MoE's ``train_loop`` on a ``(1, 1)`` mesh in microbatches of one
row; ``lm_loss`` and its gradients of Mamba-2 and Hymba on ``(2, 2)``, of
TinyLlama on ``(1, 4)``, of Hymba with its heads whole on ``model``, of
TinyLlama with masked labels and of two variants whose attention heads do
not split over ``model`` (by query blocks); and TinyLlama's and Mamba-2's prefill and
decode steps on ``(2, 2)``.  The parent computes ``repro``'s references while the ranks run, and
a subprocess runs the roofline analysis of one of the group's steps on a
fake process group of as many ranks.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
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
ANALYSIS_SIDE = r"""
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
import _sharded_ranks as ranks
from repro_torch.roofline.analysis import fake_process_group
with fake_process_group(4):
    # A CPU mesh, as the gloo group's: DTensor moves splits as it does there.
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(ranks.MESH), mesh_dim_names=("data", "model"))
    totals = ranks.counted_step(mesh, "meta")
with open(sys.argv[1], "w") as f:
    json.dump(totals, f)
"""


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


def _repro_cfg(arch, case=None):
    """repro's SMOKE config of ``arch``, at the widths of the RESHAPED loss
    case ``case``."""
    return dataclasses.replace(jcfgs.get_smoke(arch), **ranks.RESHAPED.get(case, {}))


def _weights(cfg, seed):
    """repro's parameters of ``cfg``; an SSM's per-head scalars (zero, one
    and zero at init) drawn so that they count."""
    jp = jt.init_params(cfg, jax.random.PRNGKey(20 + seed))
    if "ssm" in jp["blocks"]:
        rng = np.random.default_rng(seed)
        shape = jp["blocks"]["ssm"]["a_log"].shape
        jp["blocks"]["ssm"].update(
            {k: jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32))
             for k, scale in (("a_log", 0.5), ("d_skip", 1.0), ("dt_bias", 0.5))})
    return jp


def _repro_loss_and_grads(cfg, jp, toks, labels=None):
    """repro's lm_loss of ``cfg`` on one device, ``labels`` (the tokens where
    None), and its gradients by leaf path."""
    labels = toks if labels is None else labels
    fn = jax.jit(jax.value_and_grad(lambda p, b: jt.lm_loss(p, cfg, b), has_aux=True))
    (loss, _), grads = fn(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                               "labels": jnp.asarray(labels, jnp.int32)})
    return float(loss), {"/".join(str(k.key) for k in path): np.asarray(g)
                         for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}


def _repro_decode(arch, jp, prompt, feed):
    """repro's prefill of ``prompt``, then a decode step for each of
    ``feed``: each call's logits."""
    cfg = jcfgs.get_smoke(arch)
    logits, cache = jax.jit(jt.prefill, static_argnums=1, static_argnames="max_len")(
        jp, cfg, jnp.asarray(prompt, jnp.int32), max_len=ranks.DECODE["max_len"])
    out = [np.asarray(logits)]
    step = jax.jit(jt.decode_step, static_argnums=1)
    for tok in feed:
        logits, cache = step(jp, cfg, jnp.asarray(tok, jnp.int32), cache)
        out.append(np.asarray(logits))
    return out


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
    for arch in ranks.ONE_ROW_ARCHS:
        jtrain.train_loop(jcfgs.get_smoke(arch), steps=0, ckpt_dir=str(tmp / f"one_row_{arch}"),
                          **ranks.ONE_ROW)
        shutil.copytree(tmp / f"one_row_{arch}", tmp / f"repro_one_row_{arch}")
    models = {arch: _weights(jcfgs.get_smoke(arch), i)
              for i, arch in enumerate(ranks.WEIGHT_ARCHS)}
    reshaped = [(case, arch) for case, arch, _ in ranks.LOSS_VARIANTS if case in ranks.RESHAPED]
    models.update({case: _weights(_repro_cfg(arch, case), 10 + i)
                   for i, (case, arch) in enumerate(reshaped)})
    for name, jp in models.items():
        jckpt.save(str(tmp / name), 0, {"params": jp})
    rng = np.random.default_rng(2)
    b = ranks.DECODE["batch"]
    toks = {"loss_tokens": rng.integers(0, 512, ranks.LOSS_TOKENS),
            "prompt": rng.integers(0, 512, (b, ranks.DECODE["prompt"])),
            "feed": rng.integers(0, 512, (ranks.DECODE["steps"], b, 1))}
    whole = rng.integers(0, 512, ranks.WHOLE_HEADS_TOKENS)
    masked = rng.integers(0, 512, ranks.LOSS_TOKENS)
    masked[:, ::4] = -1
    masked[0, 1:9] = np.arange(8) * 64            # every vocab shard on (2, 2) and (1, 4)
    masked[1, 1:5] = (0, 127, 128, 511)           # the shards' edges
    toks.update({"whole_heads_tokens": whole, "whole_heads_labels": whole,
                 "masked_labels_tokens": rng.integers(0, 512, ranks.LOSS_TOKENS),
                 "masked_labels_labels": masked})
    for case, _ in reshaped:
        shape = ranks.CHUNKED_TOKENS if case == "odd_heads_chunked" else ranks.LOSS_TOKENS
        toks[f"{case}_tokens"] = toks[f"{case}_labels"] = rng.integers(0, 512, shape)
    for name, a in toks.items():
        np.save(tmp / f"{name}.npy", a.astype(np.int32))
    handle = group.start_group(tmp, 4, "stack", str(tmp), module="_sharded_ranks")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [here, os.path.join(os.path.dirname(here), "src"),
         *filter(None, [os.environ.get("PYTHONPATH")])])}
    analysis = subprocess.Popen([sys.executable, "-c", ANALYSIS_SIDE, str(tmp / "analysis.json")],
                                env=env)
    ref["train"] = _repro_train(start, str(tmp / "repro_train"), True)
    for arch in ranks.ONE_ROW_ARCHS:
        ref["one_row", arch] = jtrain.train_loop(
            jcfgs.get_smoke(arch), steps=ranks.ONE_ROW_STEPS,
            ckpt_dir=str(tmp / f"repro_one_row_{arch}"), ckpt_every=100, **ranks.ONE_ROW)[1]
    ref["cli"] = ttrain.main(ranks.CLI_ARGS)
    for arch, _ in ranks.LOSS_CASES:
        ref["loss", arch] = _repro_loss_and_grads(jcfgs.get_smoke(arch), models[arch],
                                                  toks["loss_tokens"])
    for case, arch, _ in ranks.LOSS_VARIANTS:
        ref["loss", case] = _repro_loss_and_grads(
            _repro_cfg(arch, case), models[case if case in ranks.RESHAPED else arch],
            toks[f"{case}_tokens"], toks[f"{case}_labels"])
    for arch in ranks.DECODE_ARCHS:
        ref["decode", arch] = _repro_decode(arch, models[arch], toks["prompt"], toks["feed"])
    try:
        assert analysis.wait(timeout=GROUP_LIMIT_S) == 0, "the analysis' subprocess failed"
    finally:
        if analysis.poll() is None:
            analysis.kill()
            analysis.wait()
    ref["analysis"] = json.loads((tmp / "analysis.json").read_text())
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


@pytest.mark.parametrize("arch", ranks.ONE_ROW_ARCHS)
def test_one_row_microbatches_on_a_mesh(stack, arch):
    """train_loop on a (1, 1) mesh, global batch 2 in 2 microbatches of one
    row, from repro's step 0: each step's loss within 1e-5 relative of
    repro's train_loop on the same inputs (DTensor refused to flatten a
    one-row batch split on the mesh before the batch's split kept no
    Shard of a dim of size 1)."""
    outs, ref, _ = stack
    (got_arch, got), = [o["one_row"] for o in outs if o.get("one_row", (None,))[0] == arch]
    want = ref["one_row", arch]
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(ranks.ONE_ROW_STEPS))
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want],
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose([h["lr"] for h in got], [h["lr"] for h in want], rtol=1e-6)


def _hold_loss_and_grads(outs, key, ref):
    """Every rank's loss within 1e-5 relative of repro's, and every element
    of every gradient within 1e-5."""
    want_loss, want = ref
    for o in outs:
        loss, grads = o[key][:2]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert sorted(grads) == sorted(want)
        for k, g in grads.items():
            assert g.shape == want[k].shape, k
            np.testing.assert_allclose(g, want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch,shape", ranks.LOSS_CASES)
def test_lm_loss_on_the_mesh_matches_repro(stack, arch, shape):
    """lm_loss and every gradient on a mesh, from repro's weights, against
    repro's single-device ``jax.value_and_grad(lm_loss)``: Mamba-2 and Hymba
    on (2, 2), each rank running the SSD (and Hymba's attention) on its own
    heads; TinyLlama on (1, 4), where two ranks' q heads share one kv head
    (k and v whole on ``model``, cut to that head, their gradient a partial
    sum).  The loss within 1e-5 relative, every element of every rank's
    gradients within 1e-5 (float32, the same products summed in another
    order)."""
    outs, ref, _ = stack
    _hold_loss_and_grads(outs, ("loss", arch, shape), ref["loss", arch])


@pytest.mark.parametrize("case,arch,shape", ranks.LOSS_VARIANTS)
def test_lm_loss_variants_on_the_mesh_match_repro(stack, case, arch, shape):
    """lm_loss and every gradient on a mesh against repro's single-device
    ``jax.value_and_grad(lm_loss)``, as above: Hymba with its heads whole
    on ``model`` (the published config's sharding) on 2 rows of 64 tokens,
    the SSD split by chunks over ``model`` (each rank's chunks, the chunk
    states all-gathered); and TinyLlama's loss with masked labels and
    labels in every vocab shard and on their edges, each rank gathering the
    gold logits of its own shard; attention whose heads do not split over
    ``model`` (Hymba's 5 q heads, dense and chunked; TinyLlama's 6 q heads
    whose ranks' thirds cross two kv groups), each rank running its block
    of query rows with every head, k and v whole, Hymba's sliding window on
    the rows' positions.  The loss within 1e-5 relative, every gradient within
    1e-5."""
    outs, ref, _ = stack
    _hold_loss_and_grads(outs, ("loss", case, shape), ref["loss", case])


@pytest.mark.parametrize("case", ["odd_heads", "crossed_kv"])
def test_attention_by_query_blocks_makes_no_whole_scores(stack, case):
    """Where the heads do not split over ``model``, no rank makes a tensor of
    its data shard's whole scores, forward or backward (rows x heads x L x
    L elements, ending in (L, L): every ``model`` rank computed every row of
    its data shard before), and each makes its block's (L / 2 query rows)."""
    outs, _, _ = stack
    (rows, l), heads = ranks.LOSS_TOKENS, ranks.RESHAPED[case]["n_heads"]
    rows //= ranks.MESH[0]
    for o in outs:
        made = {(tuple(s[-2:]), math.prod(s)) for s in o[("loss", case, ranks.MESH)][2]}
        assert ((l, l), rows * heads * l * l) not in made
        assert ((l // 2, l), rows * heads * l // 2 * l) in made


@pytest.mark.parametrize("arch", ranks.DECODE_ARCHS)
def test_decode_on_the_mesh_matches_repro(stack, arch):
    """prefill and 4 decode steps on the (2, 2) mesh from repro's weights,
    the KV cache's sequence split on ``model`` (each rank scoring its own
    positions, the softmax combined over the ranks; the slots written cross
    from one rank's half into the other's) and Mamba-2's state split by
    heads: every rank's logits of every call within 1e-5 of repro's
    prefill and decode_step on one device."""
    outs, ref, _ = stack
    want = ref["decode", arch]
    for o in outs:
        got, placed = o[("decode", arch)]
        if arch == "tinyllama_1_1b":
            assert placed["k"] == placed["v"] == "(Shard(dim=1), Shard(dim=2))"
        else:
            assert placed["ssm/s"] == "(Shard(dim=1), Shard(dim=2))"
        assert len(got) == len(want) == ranks.DECODE["steps"] + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, i
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"call {i}")


def test_roofline_analysis_predicts_the_group(stack):
    """The roofline analysis of TinyLlama's step on a fake group of 4 ranks,
    meta tensors on a mesh of the CPU's device type (as the gloo group's),
    equals what its counter counts on every rank of the gloo group running
    the same step for real: collective calls and bytes by kind, FLOPs and
    bytes (the same code makes the same DTensor decisions on the same local
    shapes)."""
    outs, ref, _ = stack
    want = ref["analysis"]
    assert want["collective_calls_per_dev"] and want["hlo_flops_per_dev"] > 0
    for o in outs:
        got = json.loads(json.dumps(o["counted"]))
        assert got == want


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
