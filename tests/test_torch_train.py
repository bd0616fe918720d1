"""The port's training substrate against ``repro``: the data pipeline, the
watchdog, AdamW and its schedule, int8 gradient compression, checkpoints in
both directions (bfloat16 by its bits), restart, and ``train_loop``'s
trajectory from ``repro``'s own start.

Everything runs on the CPU in float32 but the bfloat16 checkpoint and
optimizer cases.  Tolerances, each stated where it is used:

- ``train_loop``'s loss at every step within ``TRAJ_RTOL`` (1e-4 relative)
  of ``repro``'s from the same start.  Parameters are not compared tightly:
  AdamW's first steps act like a sign of the gradient, and a gradient near
  0 can take the other sign in the other package and move its parameter by
  a whole step the other way;
- a restarted run's last loss within 1e-5 relative of the uninterrupted
  run's, as ``repro``'s ``test_restart_is_exact``;
- AdamW's float32 results within ``ADAM_RTOL``; its bfloat16 parameters
  within one bf16 ulp (the float32 update can land on the other side of a
  rounding);
- compression, the data and every checkpoint exactly equal.
"""
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.data.pipeline as jdata
import repro.launch.train as jtrain
import repro.models.transformer as jt
import repro.train.checkpoint as jckpt
import repro.train.compression as jcomp
import repro.train.optimizer as jopt
import repro_torch.configs as tcfgs
import repro_torch.data.pipeline as tdata
import repro_torch.launch.train as ttrain
import repro_torch.models.transformer as tt
import repro_torch.train.checkpoint as tckpt
import repro_torch.train.compression as tcomp
import repro_torch.train.optimizer as topt
from repro_torch.train.tree import flatten, map_with_path, tree_map
from repro_torch.train.watchdog import Watchdog

TRAJ_RTOL = 1e-4
RESTART_RTOL = 1e-5
ADAM_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread, as the suite's workers share the cores: at these sizes
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_flat(tree):
    return {path_of(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# Data and watchdog.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "hubert_xlarge", "llama_3_2_vision_11b"])
def test_synthetic_data_matches_repro(arch):
    """``batch_at`` gives repro's bytes: tokens and labels, the audio
    encoder's frames (tokens None), the VLM's image embeddings."""
    cfg = jcfgs.get_smoke(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=3, seed=11,
              frontend_dim=cfg.frontend_dim,
              vision_seq=cfg.vision_seq if cfg.n_cross_layers else 0, d_model=cfg.d_model)
    ours, theirs = tdata.SyntheticLMData(**kw), jdata.SyntheticLMData(**kw)
    for step in (0, 1, 7, 1000):
        got, want = ours.batch_at(step), theirs.batch_at(step)
        assert set(got) == set(want)
        for k, w in want.items():
            if w is None:
                assert got[k] is None
            else:
                assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    assert [b["labels"].tobytes() for b, _ in zip(ours, range(3))] == \
        [theirs.batch_at(s)["labels"].tobytes() for s in range(3)]


def test_data_pipeline_deterministic_and_zipfian():
    d = tdata.SyntheticLMData(vocab_size=1000, seq_len=64, global_batch=4, seed=7)
    b1, b2 = d.batch_at(5), d.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d.batch_at(6)["tokens"], b1["tokens"])
    toks = d.batch_at(0)["tokens"]
    assert (toks < 5).mean() > 0.25


def test_watchdog_flags_slow_steps():
    wd = Watchdog(slow_factor=2.0, ema_decay=0.5)
    for _ in range(3):
        wd.start_step()
        time.sleep(0.01)
        wd.end_step()
    wd.start_step()
    time.sleep(0.08)
    stats = wd.end_step()
    assert stats["slow"] and wd.slow_steps >= 1 and not wd.hung()


# ---------------------------------------------------------------------------
# AdamW, its schedule, compression.
# ---------------------------------------------------------------------------

def test_lr_at_matches_repro():
    """Warm-up, the cosine and its floor, in float32."""
    cfg = topt.OptimizerConfig(warmup_steps=10, total_steps=50)
    jcfg = jopt.OptimizerConfig(warmup_steps=10, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    got = topt.lr_at(cfg, torch.from_numpy(steps))
    want = np.asarray(jopt.lr_at(jcfg, jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=ADAM_RTOL)
    assert got[5] < got[10] and got[59] == pytest.approx(cfg.lr * cfg.min_lr_ratio)


def _opt_inputs(seed):
    """A tree of float32 and bfloat16 leaves and three steps of gradients,
    as numpy (bfloat16 as float32 values that bfloat16 holds exactly)."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    params = {"w": rng.standard_normal((6, 5), dtype=np.float32),
              "blk": {"b": bf16(rng.standard_normal(7)), "s": np.full(3, 1.5, np.float32)}}
    grads = [{"w": rng.standard_normal((6, 5), dtype=np.float32),
              "blk": {"b": bf16(rng.standard_normal(7) * 3),
                      "s": rng.standard_normal(3).astype(np.float32)}} for _ in range(3)]
    return params, grads


BF16_LEAVES = {"blk/b"}


def path_of(keys):
    return "/".join(str(k.key) for k in keys)


def as_port(tree):
    return map_with_path(lambda p, a: torch.from_numpy(np.array(a)).to(
        torch.bfloat16 if p in BF16_LEAVES else torch.float32), tree)


def as_jax(tree):
    return jax.tree_util.tree_map_with_path(lambda p, a: jnp.asarray(
        a, jnp.bfloat16 if path_of(p) in BF16_LEAVES else jnp.float32), tree)


def test_adamw_update_matches_repro():
    """Three steps on float32 and bfloat16 leaves (bfloat16 gradients too):
    parameters, m, v, grad_norm and lr against repro's; the port updates the
    tensors it was given, where repro donates them."""
    params, grads = _opt_inputs(0)
    cfg = topt.OptimizerConfig(warmup_steps=2, total_steps=5, clip_norm=2.0)
    jcfg = jopt.OptimizerConfig(warmup_steps=2, total_steps=5, clip_norm=2.0)
    tp, jp = as_port(params), as_jax(params)
    tstate, jstate = topt.init_opt_state(tp), jopt.init_opt_state(jp)
    w = tp["w"]
    for g in grads:
        tp, tstate, tm = topt.adamw_update(tp, tstate, as_port(g), cfg)
        jp, jstate, jm = jopt.adamw_update(jp, jstate, as_jax(g), jcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=ADAM_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=ADAM_RTOL)
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["step"].dtype == torch.int32
        for path, want in jax_flat(jp).items():
            got = flatten(tp)[path]
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
            got, want = got.float().numpy(), want.astype(np.float32)
            if path in BF16_LEAVES:     # one bf16 ulp: 2^-7 of the leading bit
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_allclose(got, want, rtol=ADAM_RTOL, atol=1e-7)
        for name in ("m", "v"):
            for path, want in jax_flat(jstate[name]).items():
                got = flatten(tstate[name])[path]
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), want, rtol=ADAM_RTOL, atol=1e-9)
    assert tp["w"] is w


def test_adamw_step_moves_params():
    params = {"w": torch.ones((4, 4), dtype=torch.float32)}
    opt = topt.init_opt_state(params)
    before = params["w"].clone()
    new_params, new_opt, m = topt.adamw_update(
        params, opt, {"w": torch.ones((4, 4), dtype=torch.float32)}, topt.OptimizerConfig())
    assert int(new_opt["step"]) == 1
    assert not torch.equal(new_params["w"], before)
    assert float(m["grad_norm"]) == pytest.approx(4.0)


def test_compress_decompress_equals_repro():
    """Round half to even in both: on the same gradients and error state
    (ties included: values at exact half steps of the scale), the results
    are equal, not close; three steps of error feedback."""
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal((9, 7)).astype(np.float32),
         "t": {"ties": (np.arange(-6, 7, dtype=np.float32) + 0.5) * (12.7 / 127),
               "zero": np.zeros(4, np.float32)}}
    tg, jg = tree_map(torch.from_numpy, g), jax.tree.map(jnp.asarray, g)
    tstate, jstate = tcomp.init_state(tg), jcomp.init_state(jg)
    for _ in range(3):
        (th, tstate), (jh, jstate) = (tcomp.compress_decompress(tg, tstate),
                                      jcomp.compress_decompress(jg, jstate))
        for got, want in ((th, jh), (tstate, jstate)):
            for path, w in jax_flat(want).items():
                assert flatten(got)[path].numpy().tobytes() == w.tobytes(), path
    q, _ = tcomp._quantize(torch.from_numpy(g["w"]))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127


def test_grad_compression_error_feedback():
    """EF accumulates: the mean dequantized gradient converges to the true
    mean (repro's test on the port)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(64) * 1e-3)}
    state = tcomp.init_state(g)
    acc = torch.zeros(64, dtype=torch.float32)
    for _ in range(50):
        ghat, state = tcomp.compress_decompress(g, state)
        acc = acc + ghat["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)},
            "s": torch.zeros((), dtype=torch.int32)}
    tckpt.save(str(tmp_path), 3, tree, extra={"note": "x"})
    assert tckpt.latest_step(str(tmp_path)) == 3
    out, extra = tckpt.restore(str(tmp_path), 3, tree)
    for path, t in flatten(tree).items():
        assert torch.equal(flatten(out)[path], t) and flatten(out)[path].dtype == t.dtype
    assert extra["note"] == "x"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="missing keys"):
        tckpt.restore(str(tmp_path), 3, {**tree, "new": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), 3, {**tree, "a": torch.zeros(3, 2)})


def test_async_checkpointer_copies_before_returning(tmp_path):
    """``save`` returns with the leaves on the host: a step that updates a
    tensor in place right after cannot reach the checkpoint."""
    tree = {"w": torch.zeros((128, 128))}
    w = tckpt.AsyncCheckpointer()
    w.save(str(tmp_path), 1, tree)
    tree["w"].add_(1.0)
    w.save(str(tmp_path), 2, tree)      # waits for the first
    w.wait()
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert w.last_path == os.path.join(str(tmp_path), "step_2")
    one, _ = tckpt.restore(str(tmp_path), 1, tree)
    two, _ = tckpt.restore(str(tmp_path), 2, tree)
    assert float(one["w"].abs().max()) == 0.0 and float(two["w"].min()) == 1.0


def _bf16_specials():
    """float32 values that bfloat16 holds exactly, specials and subnormals
    included."""
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.standard_normal(20).astype(np.float32),
                           np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e38], np.float32)])
    return np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))


def test_bfloat16_roundtrips_bit_for_bit(tmp_path):
    """The port writes a bfloat16 leaf as its bits (``V2``, "bfloat16" in
    the manifest) and reads it back by them: equal bits, NaN payloads too."""
    bits = np.arange(-32768, 32768, 97, dtype=np.int32).astype(np.int16)
    tree = {"w": torch.from_numpy(bits).view(torch.bfloat16), "f": torch.ones(3)}
    tckpt.save(str(tmp_path), 0, tree)
    data = np.load(tmp_path / "step_0" / "arrays.npz")
    assert data["w"].dtype == np.dtype("V2")
    out, _ = tckpt.restore(str(tmp_path), 0, tree)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), tree["w"].view(torch.int16))


def test_repro_bfloat16_checkpoint_reads_as_params_from_numpy(tmp_path):
    """A bfloat16 ``arrays.npz`` that repro wrote reads equal to
    ``params_from_numpy`` of the same tree (repro's own ``restore`` cannot
    cast those voids)."""
    vals = _bf16_specials()
    jtree = {"blocks": {"w": jnp.asarray(vals.reshape(2, 13), jnp.bfloat16)},
             "step": jnp.int32(5), "f": jnp.asarray(vals, jnp.float32)}
    jckpt.save(str(tmp_path), 5, jtree)
    want = tt.params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    target = tree_map(torch.zeros_like, want)
    got, _ = tckpt.restore(str(tmp_path), 5, target)
    for path, w in flatten(want).items():
        g = flatten(got)[path]
        assert g.dtype == w.dtype, path
        if w.dtype == torch.bfloat16:       # compare bits: -0.0 and NaNs too
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert g.numpy().tobytes() == w.numpy().tobytes(), path


def test_port_float32_checkpoint_restores_in_repro(tmp_path):
    """Two of the port's steps, then repro restores the port's last
    checkpoint into its own tree: every parameter and moment equal, the
    int32 step too."""
    cfg = tcfgs.get_smoke("tinyllama_1_1b")
    params, hist = ttrain.train_loop(cfg, steps=2, global_batch=2, seq_len=16,
                                     ckpt_dir=str(tmp_path), device="cpu")
    jcfg = jcfgs.get_smoke("tinyllama_1_1b")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(1))
    target = {"params": jparams, "opt": jopt.init_opt_state(jparams)}
    restored, extra = jckpt.restore(str(tmp_path), 2, target)
    assert extra == {"step": 2}
    want = tckpt.restore(str(tmp_path), 2, {"params": params,
                                            "opt": topt.init_opt_state(params)})[0]
    got = jax_flat(restored)
    for path, w in flatten(want).items():
        assert got[path].dtype == w.detach().numpy().dtype, path
        assert got[path].tobytes() == w.detach().numpy().tobytes(), path
    assert int(restored["opt"]["step"]) == 2
    for path, w in flatten(params).items():
        assert got[f"params/{path}"].tobytes() == w.detach().numpy().tobytes(), path


# ---------------------------------------------------------------------------
# train_loop: repro's trajectory from repro's start, restart.
# ---------------------------------------------------------------------------

TRAJECTORIES = {
    # (arch, steps, global batch, seq len, microbatches, compress): the first
    # is repro's test_loss_decreases_single_device, the second its
    # test_train_with_microbatches_and_compression.
    "plain": ("tinyllama_1_1b", 12, 4, 64, 1, False),
    "microbatches_compress": ("tinyllama_1_1b", 6, 4, 32, 2, True),
}


@pytest.fixture(scope="module")
def repro_runs(tmp_path_factory):
    """``runs(name)``: (the directory in which repro committed step 0 of
    ``train_loop``, its initial parameters and optimizer state; repro's
    history over the run), once per module."""
    done = {}

    def get(name):
        if name not in done:
            arch, steps, b, l, mb, comp = TRAJECTORIES[name]
            cfg = jcfgs.get_smoke(arch)
            start = str(tmp_path_factory.mktemp(f"repro_{name}"))
            jtrain.train_loop(cfg, steps=0, global_batch=b, seq_len=l, ckpt_dir=start)
            _, hist = jtrain.train_loop(cfg, steps=steps, global_batch=b, seq_len=l,
                                        microbatches=mb, compress_grads=comp)
            done[name] = start, hist
        return done[name]
    return get


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_train_loop_follows_repro(repro_runs, tmp_path, name):
    """The port restores repro's step 0 and trains: its loss at every step
    within TRAJ_RTOL of repro's, the same metric keys, lr equal; the loss
    falls."""
    arch, steps, b, l, mb, comp = TRAJECTORIES[name]
    start, want = repro_runs(name)
    shutil.copytree(start, tmp_path / "ckpt")
    _, hist = ttrain.train_loop(tcfgs.get_smoke(arch), steps=steps, global_batch=b,
                                seq_len=l, microbatches=mb, compress_grads=comp,
                                ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    assert [h["step"] for h in hist] == [h["step"] for h in want] == list(range(steps))
    assert set(hist[0]) == set(want[0])
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in want],
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose([h["lr"] for h in hist], [h["lr"] for h in want],
                               rtol=ADAM_RTOL)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.fixture(scope="module")
def stablelm_runs(tmp_path_factory):
    """repro's restart scenario (test_restart_is_exact) on stablelm's SMOKE
    config: repro's uninterrupted history, and the directory in which its
    run that failed at step 6 committed step 4."""
    cfg = jcfgs.get_smoke("stablelm_1_6b")
    _, full = jtrain.train_loop(cfg, steps=8, global_batch=4, seq_len=32)
    d = str(tmp_path_factory.mktemp("repro_failed"))
    with pytest.raises(RuntimeError, match="injected failure"):
        jtrain.train_loop(cfg, steps=8, global_batch=4, seq_len=32, ckpt_dir=d,
                          ckpt_every=4, fail_at_step=6)
    return full, d


def test_restart_is_exact(tmp_path):
    """Interrupted port run + restart == uninterrupted port run."""
    cfg = tcfgs.get_smoke("stablelm_1_6b")
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(steps=8, global_batch=4, seq_len=32, device="cpu")
    _, full = ttrain.train_loop(cfg, ckpt_dir=d1, ckpt_every=100, **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train_loop(cfg, ckpt_dir=d2, ckpt_every=4, fail_at_step=6, **kw)
    assert tckpt.latest_step(d2) == 4
    _, resumed = ttrain.train_loop(cfg, ckpt_dir=d2, ckpt_every=4, **kw)
    assert resumed[0]["step"] == 4
    np.testing.assert_allclose(full[-1]["loss"], resumed[-1]["loss"], rtol=RESTART_RTOL)
    assert not [f for f in os.listdir(d2) if f.endswith(".tmp")]


def test_repro_checkpoint_restores_and_trains_as_repro(stablelm_runs, tmp_path):
    """repro's run failed at step 6 with step 4 committed; the port resumes
    from that checkpoint (parameters, moments and step) and its steps 4–7
    follow repro's uninterrupted run."""
    full, d = stablelm_runs
    shutil.copytree(d, tmp_path / "ckpt")
    _, resumed = ttrain.train_loop(tcfgs.get_smoke("stablelm_1_6b"), steps=8,
                                   global_batch=4, seq_len=32, ckpt_every=4,
                                   ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    assert [h["step"] for h in resumed] == [4, 5, 6, 7]
    np.testing.assert_allclose([h["loss"] for h in resumed], [h["loss"] for h in full[4:]],
                               rtol=TRAJ_RTOL)


def test_mesh_is_the_next_slice(tmp_path):
    """The sharded path no longer raises: in a gloo group of one, ``mesh=``
    a ``(1, 1)`` mesh and ``--mesh 1x1:data,model`` train as on one device
    (``tests/test_torch_sharded.py`` holds a ``(2, 2)`` mesh of 4 ranks)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    cfg = tcfgs.get_smoke("tinyllama_1_1b")
    kw = dict(steps=2, global_batch=2, seq_len=16, device="cpu")
    _, plain = ttrain.train_loop(cfg, **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        _, meshed = ttrain.train_loop(cfg, mesh=make_mesh((1, 1), ("data", "model"),
                                                          device="cpu"), **kw)
        cli = ttrain.main(["--arch", "tinyllama_1_1b", "--smoke", "--steps", "2",
                           "--global-batch", "2", "--seq-len", "16", "--mesh",
                           "1x1:data,model", "--device", "cpu"])
    finally:
        dist.destroy_process_group()
    for hist in (meshed, cli):
        np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in plain],
                                   rtol=RESTART_RTOL)


def test_cli_trains_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train``: the loss falls; a second call
    with more steps resumes from the first's last checkpoint."""
    argv = ["--arch", "tinyllama_1_1b", "--smoke", "--seq-len", "32", "--global-batch", "4",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = ttrain.main(argv + ["--steps", "6"])
    assert first[-1]["loss"] < first[0]["loss"]
    again = ttrain.main(argv + ["--steps", "8"])
    assert [h["step"] for h in again] == [6, 7]
    assert "restored step 6" in capsys.readouterr().out
