"""The port's sharding rules, meta-device specs and dry run against
``repro``'s.

``repro``'s side runs once, in a subprocess with 512 forced CPU devices
(``repro``'s production meshes need them; jax fixes the device count at
its first use): for every config of the ten, full and SMOKE, the shapes
and dtypes of ``jax.eval_shape(init_params)``, every leaf's
``param_spec`` and fitted spec (``params_sharding_tree``) on the
``(16, 16)`` and ``(2, 16, 16)`` meshes, and ``make_activation_policy``'s
specs.  The port computes the same on ``ShapeMesh``es (names and sizes)
and meta tensors.  ``repro``'s own mini dry run fails here on jax 0.9
(ROADMAP.md §3); the port's runs its scenario.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import ShapeMesh, dp_axes, make_production_mesh
from repro_torch.models.sharding import (
    P,
    ActivationPolicy,
    batch_split,
    get_policy,
    make_activation_policy,
    param_spec,
    params_sharding_tree,
    placements,
    shard_activation,
    use_policy,
)
from repro_torch.train.tree import flatten

MESHES = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}
KINDS = ("full", "smoke")

REPRO_SIDE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from functools import partial
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, get_config, get_smoke
from repro.launch.mesh import dp_axes, make_production_mesh
from repro.models.sharding import make_activation_policy, param_spec, params_sharding_tree
from repro.models.transformer import init_params

def norm(spec):
    return tuple(None if e is None else e if isinstance(e, str)
                 else (e[0] if len(e) == 1 else tuple(e)) for e in spec)

def flat(tree, is_leaf=None):
    return {"/".join(p.key for p in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}

meshes = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}
out = {"policy": {m: {k: norm(v) for k, v in make_activation_policy(
    mesh, get_config("tinyllama_1_1b"), dp=dp_axes(mesh)).specs.items()}
    for m, mesh in meshes.items()}}
key = jax.ShapeDtypeStruct((2,), jnp.uint32)
for arch in ARCH_IDS:
    for kind, cfg in (("full", get_config(arch)), ("smoke", get_smoke(arch))):
        sds = jax.eval_shape(partial(init_params, cfg), key)
        leaves = flat(sds)
        out[arch, kind, "shapes"] = {k: (tuple(v.shape), str(v.dtype)) for k, v in leaves.items()}
        for m, mesh in meshes.items():
            dp = dp_axes(mesh)
            tree = params_sharding_tree(sds, cfg, mesh, dp=dp)
            shardings = flat(tree, lambda x: isinstance(x, NamedSharding))
            out[arch, kind, m, "fitted"] = {k: norm(v.spec) for k, v in shardings.items()}
            out[arch, kind, m, "raw"] = {
                k: norm(param_spec(tuple(k.split("/")), len(v.shape), cfg, dp=dp, tp_size=16))
                for k, v in leaves.items()}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("repro_specs") / "specs.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", REPRO_SIDE, str(path)], check=True, env=env,
                   timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg(arch, kind):
    return tcfgs.get_config(arch) if kind == "full" else tcfgs.get_smoke(arch)


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_params_specs_match_eval_shape(repro_side, arch):
    """The meta parameter tree: repro's paths, shapes and dtypes, full and
    SMOKE, with no memory."""
    for kind in KINDS:
        tree = flatten(specs.params_specs(_cfg(arch, kind)))
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree.items()}
        assert got == repro_side[arch, kind, "shapes"], kind
        assert all(v.device.type == "meta" for v in tree.values())


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_param_specs_match_repro(repro_side, arch):
    """``param_spec`` and the fitted specs of every leaf, full and SMOKE, on
    both production meshes, equal to repro's."""
    for kind in KINDS:
        cfg = _cfg(arch, kind)
        tree = specs.params_specs(cfg)
        for name, mesh in MESHES.items():
            dp = dp_axes(mesh)
            fitted = flatten(params_sharding_tree(tree, cfg, mesh, dp=dp))
            assert {k: tuple(v) for k, v in fitted.items()} == \
                repro_side[arch, kind, name, "fitted"], (kind, name)
            raw = {k: tuple(param_spec(tuple(k.split("/")), v.ndim, cfg, dp=dp, tp_size=16))
                   for k, v in flatten(tree).items()}
            assert raw == repro_side[arch, kind, name, "raw"], (kind, name)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_activation_policy_matches_repro(repro_side, name):
    mesh = MESHES[name]
    got = make_activation_policy(mesh, tcfgs.get_config("tinyllama_1_1b"), dp=dp_axes(mesh))
    assert {k: tuple(v) for k, v in got.specs.items()} == repro_side["policy"][name]
    assert got.mesh is mesh


def test_partition_spec_and_placements():
    """P reads entries as jax's PartitionSpec; placements put each mesh axis
    on the dim the spec names, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    assert P(("data",), None) == ("data", None) and P((), "model") == (None, "model")
    assert P(("pod", "data"), None)[0] == ("pod", "data")
    mesh = ShapeMesh(("pod", "data", "model"), (2, 4, 8))
    assert placements(P(("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert placements(P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(AssertionError, match="orders"):
        placements(P(("data", "pod"), None), mesh)
    with pytest.raises(AssertionError, match="twice"):
        placements(P("model", "model"), mesh)


def test_shard_activation_is_the_identity_off_the_mesh():
    """No policy, a kind without a spec, or a plain tensor: the tensor
    itself; the policy is thread-local and restored on exit."""
    x = torch.randn(2, 4, 8)
    assert shard_activation(x, "residual") is x and batch_split(x) is x
    pol = ActivationPolicy(specs={"residual": P("data", None, None)},
                           mesh=ShapeMesh(("data",), (1,)))
    with use_policy(pol):
        assert get_policy() is pol
        assert shard_activation(x, "residual") is x
        assert shard_activation(x, "logits") is x
    assert get_policy() is None


def test_mini_dryrun_multipod_axes(monkeypatch):
    """repro's mini dry run: the qwen3-moe SMOKE config at 64 x 8 on a
    (2, 2, 2) (pod, data, model) mesh: status ok, FLOPs > 0, each device's
    argument bytes below the whole."""
    monkeypatch.setitem(specs.SHAPES, "train_4k", tcfgs.ShapeSpec("train_4k", 64, 8, "train"))
    mesh = ShapeMesh(("pod", "data", "model"), (2, 2, 2))
    cfg = tcfgs.get_smoke("qwen3_moe_30b_a3b")
    rec = dryrun.run_cell("qwen3_moe_30b_a3b", "train_4k", mesh, cfg=cfg, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2" and rec["flops"] > 0
    leaves = flatten(specs.params_specs(cfg)).values()
    assert rec["params"] == sum(t.numel() for t in leaves)
    assert 0 < rec["param_bytes"] < sum(t.numel() * t.element_size() for t in leaves)


def test_dryrun_cli_skips_and_runs(capsys):
    """The CLI: repro's skip reason for a cell that does not run, a record
    for each mesh of one that does."""
    recs = dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k", "--both-meshes"])
    assert recs == [{"arch": "hubert_xlarge", "shape": "decode_32k", "status": "skip",
                     "reason": tcfgs.skip_reason("hubert_xlarge", "decode_32k")}]
    recs = dryrun.main(["--arch", "mamba2_780m", "--shape", "decode_32k", "--both-meshes"])
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" and r["flops"] > 0 for r in recs)
    assert recs[1]["argument_size_in_bytes"] < recs[0]["argument_size_in_bytes"]
    assert "0 failures" in capsys.readouterr().out
