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

import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.launch import specs
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


DRYRUN_SIDE = r"""
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.roofline.analysis import fake_process_group

out = {}
full = dict(specs.SHAPES)
specs.SHAPES["train_4k"] = configs.ShapeSpec("train_4k", 64, 8, "train")
specs.SHAPES["decode_32k"] = configs.ShapeSpec("decode_32k", 64, 8, "decode")
mesh = ShapeMesh(("pod", "data", "model"), (2, 2, 2))
with fake_process_group(8):
    out["mini"] = dryrun.run_cell("qwen3_moe_30b_a3b", "train_4k", mesh,
                                  cfg=configs.get_smoke("qwen3_moe_30b_a3b"), verbose=False)
    out["ssm_decode"] = dryrun.run_cell("mamba2_780m", "decode_32k", mesh,
                                        cfg=configs.get_smoke("mamba2_780m"), verbose=False)
specs.SHAPES.update(full)
out["skip"] = dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k", "--both-meshes"])
out["run"] = dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "decode_32k", "--both-meshes"])
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""
ANALYSIS_KEYS = ("hlo_flops_per_dev", "collective_bytes_per_dev", "peak_memory_in_bytes",
                 "compute_s", "memory_s", "collective_s", "dominant", "useful_flops_ratio")


@pytest.fixture(scope="module")
def dryrun_side(tmp_path_factory):
    """The dry run's records, from a subprocess (each of its fake process
    groups needs a process of its own), and what it printed."""
    path = tmp_path_factory.mktemp("dryrun") / "records.json"
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [src, *filter(None, [os.environ.get("PYTHONPATH")])])}
    done = subprocess.run([sys.executable, "-c", DRYRUN_SIDE, str(path)], env=env,
                          timeout=600, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    with open(path) as f:
        return json.load(f), done.stdout


def test_mini_dryrun_multipod_axes(dryrun_side):
    """repro's mini dry run: the qwen3-moe SMOKE config at 64 x 8 on a
    (2, 2, 2) (pod, data, model) mesh of a fake process group: status ok,
    repro's analysis keys, FLOPs > 0, each device's argument bytes below
    the whole, collectives on the split mesh, the expert all-to-all among
    them."""
    rec = dryrun_side[0]["mini"]
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2" and rec["chips"] == 8
    assert all(k in rec for k in ANALYSIS_KEYS)
    assert rec["flops"] == rec["hlo_flops_per_dev"] > 0
    cfg = tcfgs.get_smoke("qwen3_moe_30b_a3b")
    leaves = flatten(specs.params_specs(cfg)).values()
    assert rec["params"] == sum(t.numel() for t in leaves)
    assert 0 < rec["param_bytes"] < sum(t.numel() * t.element_size() for t in leaves)
    assert rec["argument_size_in_bytes"] <= rec["peak_memory_in_bytes"]
    assert rec["collective_bytes_per_dev"]["all-to-all"] > 0
    assert rec["collective_total_per_dev"] > rec["collective_bytes_per_dev"]["all-to-all"]


def test_mini_dryrun_ssm_decode(dryrun_side):
    """The SSM's decode step on a mesh: Mamba-2's SMOKE config, decode_32k
    cut to 8 rows of a 64-position cache, on the (2, 2, 2) mesh (its state
    split by heads on ``model``): status ok, repro's analysis keys, FLOPs
    and collectives."""
    rec = dryrun_side[0]["ssm_decode"]
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2" and rec["chips"] == 8
    assert all(k in rec for k in ANALYSIS_KEYS)
    assert rec["flops"] == rec["hlo_flops_per_dev"] > 0
    assert rec["collective_total_per_dev"] > 0
    assert rec["argument_size_in_bytes"] <= rec["peak_memory_in_bytes"]


def test_dryrun_cli_skips_and_runs(dryrun_side):
    """The CLI: repro's skip reason for a cell that does not run, a record
    for each mesh of one that does (TinyLlama's decode step at full width,
    one of the quicker cells on the 512 ranks), with repro's analysis keys,
    collectives on both production meshes, and each device's share of the
    work halved on the mesh of twice the ranks."""
    out, printed = dryrun_side
    assert out["skip"] == [{"arch": "hubert_xlarge", "shape": "decode_32k", "status": "skip",
                            "reason": tcfgs.skip_reason("hubert_xlarge", "decode_32k")}]
    recs = out["run"]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" and r["flops"] > 0 for r in recs)
    assert all(k in r for r in recs for k in ANALYSIS_KEYS)
    assert all(r["collective_total_per_dev"] > 0 for r in recs)
    assert recs[1]["argument_size_in_bytes"] < recs[0]["argument_size_in_bytes"]
    assert recs[1]["hlo_flops_per_dev"] * 2 == recs[0]["hlo_flops_per_dev"]
    assert printed.count("0 failures") == 2
