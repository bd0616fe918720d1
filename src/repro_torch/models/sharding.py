"""Logical-axis sharding rules and the activation-constraint hook: the
counterpart of ``repro/models/sharding.py`` on a ``torch.distributed``
``DeviceMesh``, with DTensor in the role of GSPMD.

Model code stays sharding-agnostic; the launch layer installs an
:class:`ActivationPolicy` (a :class:`P` per activation kind) and
distributes the parameters by the rule table.  ``shard_activation(x,
kind)`` is the identity unless a policy is active and ``x`` is a DTensor,
so one-card runs never see mesh machinery.  Under a policy, the constraint
is a ``redistribute`` of the DTensor to the spec's placements, and between
constraints DTensor's sharding propagation plays the partitioner.

A spec is :class:`P`: one entry per tensor dim, each an axis name, a tuple
of names (that dim split over several mesh axes, the first the major
one), or None.  :func:`placements` turns it into one placement per mesh
dim: ``Shard(d)`` where the spec puts that axis on dim ``d``,
``Replicate()`` elsewhere.

Parameter rules (Megatron/FSDP hybrid, ``repro``'s table):
  weights   (.., D_in, D_out)-like: TP shards the "wide" axis on ``model``,
  FSDP shards the other on ``(pod?, data)``.
  experts   expert-sharded: E on ``model``; tensor-sharded: d_ff on ``model``.
  caches    KV sequence axis on ``model`` (``launch/specs.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.train.tree import map_with_path, tree_map

_ctx = threading.local()

__all__ = ["P", "ActivationPolicy", "set_policy", "get_policy", "use_policy",
           "shard_activation", "make_activation_policy", "param_spec",
           "params_sharding_tree", "placements", "distribute_params", "shard_params",
           "batch_split", "replicated", "grad_placed_like", "keep_grad_split", "even_split",
           "split_columns", "split_heads",
           "on_local_heads",
           "batch_axes", "batch_placements",
           "cache_sharding_tree", "zeros_placed"]


class P(tuple):
    """A partition spec: ``P("data", None)``.  An entry is an axis name, a
    tuple of names or None; a one-name tuple is that name and an empty one
    None, as ``jax.sharding.PartitionSpec`` reads them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ActivationPolicy:
    """P per activation kind; a kind with no entry is unconstrained."""

    specs: dict[str, P]
    mesh: Any = None

    def spec(self, kind: str) -> P | None:
        return self.specs.get(kind)


def set_policy(policy: ActivationPolicy | None) -> None:
    _ctx.policy = policy


def get_policy() -> ActivationPolicy | None:
    return getattr(_ctx, "policy", None)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication for the block, as it was after it.
    ``torch.distributed.tensor.experimental.implicit_replication`` turns it
    off on exit whatever it was, and its flag is process-wide in torch 2.11
    (per thread in 2.13), so a nested block (remat's recomputation) would
    turn it off under the step that runs it."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


class use_policy:
    """Install ``policy`` for the block, on this thread.  With a policy,
    plain tensors that meet DTensors in one operation (positions, masks, the
    MoE's buffers: every rank makes the same whole tensor) count as
    replicated: DTensor's implicit replication, restored after the block."""

    def __init__(self, policy: ActivationPolicy | None):
        self.policy = policy

    def __enter__(self):
        self.prev = get_policy()
        set_policy(self.policy)
        self._stack = contextlib.ExitStack()
        if self.policy is not None:
            self._stack.enter_context(_implicit_replication())
        return self.policy

    def __exit__(self, *exc):
        self._stack.close()
        set_policy(self.prev)


def shard_activation(x, kind: str):
    """``x`` redistributed to the active policy's spec for ``kind``; ``x``
    itself without a policy, for a kind with no spec, or for a plain
    tensor."""
    pol = get_policy()
    if pol is None:
        return x
    spec = pol.spec(kind)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, pol.mesh))


def batch_placements(x) -> list:
    """``x``'s placements with only its batch split kept: ``Shard(0)`` where
    ``x`` has it, ``Replicate()`` elsewhere.  A batch of one row splits over
    nothing: DTensor's view rules drop a dim of size 1 and refuse to drop a
    split one."""
    from torch.distributed.tensor import Replicate, Shard

    split = x.shape[0] > 1
    return [p if p == Shard(0) and split else Replicate() for p in x.placements]


def _batch_only(x):
    want = batch_placements(x)
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


class _BatchSplitGrad(torch.autograd.Function):
    """The identity, whose backward gives the gradient :func:`batch_split`'s
    placements."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _batch_only(g)


def batch_split(x):
    """A DTensor split on its leading (batch) axis alone, and its gradient
    too: every other split gathered and every partial sum reduced; a plain
    tensor as it is.

    Each block section, the MoE's token flatten, and the attention and the
    SSD where their heads do not split on ``model`` take it (elsewhere they
    run on each rank's heads: :func:`on_local_heads`): DTensor's view rules
    (torch 2.11) refuse to flatten an axis split on the mesh unless it leads
    the flattened group, so the sequence and head axes are made whole first,
    forward and backward, as ``repro``'s ``shard_activation`` makes a
    placement explicit."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    x = _batch_only(x)
    return _BatchSplitGrad.apply(x) if x.requires_grad else x


def replicated(x):
    """A DTensor whole on every rank (partial sums reduced); a plain tensor
    as it is.  The token ids of the embedding gather take it (DTensor's
    rule for the gradient of indexing, ``index_put``, fails on split
    indices in torch 2.11), and so does the ``gspmd`` MoE's routing."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or all(p == Replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


class _GradLikeValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.place = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.place)


def grad_placed_like(t):
    """``t``; where it is a DTensor, its gradient is brought to ``t``'s
    placements on the way back.  A tensor used twice (tied embeddings: the
    token gather and the LM head) takes it at each use, so that autograd
    sums two gradients placed alike: torch 2.11's DTensor cannot bring one
    use's split gradient to the other's partial sum."""
    from torch.distributed.tensor import DTensor

    return _GradLikeValue.apply(t) if isinstance(t, DTensor) else t


def keep_grad_split(t, dim: int):
    """``t``; where it is a DTensor split on dim ``dim``, its gradient is
    brought back to ``t``'s placements on the way back.  Without it the
    gated SSM's gradient of ``z`` comes back split by batch or sequence on
    ``model``; on a mesh of three axes, with a few rows a rank, that reaches
    the product's weight gradient as a strided split of the tokens, which
    DTensor's product rule gathers: every ``model`` rank computed the whole
    weight gradient."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor) or Shard(dim) not in t.placements:
        return t
    return grad_placed_like(t)


def even_split(t, dim: int, n: int):
    """``t`` with its split of dim ``dim`` kept over the mesh axes whose
    sizes divide ``n`` (the count of heads the dim holds) and gathered over
    the rest; a plain tensor as it is.  DTensor flattens and unflattens a
    split dim only where the split lands evenly on its leading part."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    mesh, parts, want = t.device_mesh, 1, list(t.placements)
    for i, p in enumerate(want):
        if p == Shard(dim):
            if n % (parts * mesh.size(i)):
                want[i] = Replicate()
            else:
                parts *= mesh.size(i)
    return t if want == list(t.placements) else t.redistribute(mesh, want)


def split_columns(w, n: int):
    """``w.split(n, dim=-1)``; on a mesh each part split over the mesh axes
    that split ``w``'s last dim, so that a product with it stays split by
    columns, forward and backward (the parts of a split dim lie on other
    ranks than the whole's: ``w`` is gathered on those axes and each part
    cut again there, which moves the weight instead of the product)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor):
        return w.split(n, dim=-1)
    mesh, place, d = w.device_mesh, list(w.placements), w.ndim - 1
    whole = [Replicate() if p == Shard(d) else p for p in place]
    return tuple(t.redistribute(mesh, place)
                 for t in w.redistribute(mesh, whole).split(n, dim=-1))


def split_heads(t, n: int):
    """``t`` (B, L, n·dh) viewed as (B, L, n, dh), split only as evenly as
    ``n`` heads allow (:func:`even_split`)."""
    b, l, _ = t.shape
    return even_split(t, 2, n).reshape(b, l, n, -1)


def on_local_heads(fn, q, k, v, q_pos, k_pos, **kwargs):
    """``fn(q, k, v, q_pos, k_pos, **kwargs)`` -> (B, Lq, Hq, dh), an
    attention over (B, L, H, dh) operands with the positions ``q_pos`` (Lq,)
    and ``k_pos`` (Lk,) of their rows, run on each rank's share.

    Plain tensors: ``fn`` itself.  DTensors: each rank runs ``fn`` on plain
    local tensors, the batch split as ``q``'s (:func:`batch_split`), and
    what else each holds depends on the ``model`` axis (``ntp`` ranks):

    * nothing more where there is no ``model`` axis or ``ntp`` is 1;
    * by heads, where the q heads divide ``ntp`` and each rank's q heads
      lie in one kv group, as ``repro``'s partitioner keeps the heads on
      ``model``: the q heads split on ``model``; k and v split alike where
      their heads divide, else whole on ``model`` and cut to the one kv head
      that the rank's q heads share (their gradient a partial sum over
      ``model``).  The result is split by heads.
    * by query blocks, where the heads do not split so (q heads not
      divisible, or a rank's q heads across two kv groups) and ``ntp``
      divides Lq: each rank its contiguous block of Lq / ``ntp`` query rows
      and their positions, every head; k, v and ``k_pos`` whole on
      ``model`` (k's and v's gradient a partial sum over ``model``), so
      causal and sliding-window masks stay exact.  A ``q_chunk`` keyword
      (the chunked form's) is cut to divide the block.  The result is split
      on the sequence over ``model``, as ``repro``'s residual is.  Equal
      blocks leave the later ones more unmasked scores under a causal mask.

    Where none applies (the batch already split on ``model``; heads that do
    not split and ``ntp`` not dividing Lq, as some prefill and decode
    lengths), every rank runs ``fn`` on DTensors with only the batch split,
    every head and row gathered: each ``model`` rank repeats the work."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(q, DTensor):
        return fn(q, k, v, q_pos, k_pos, **kwargs)
    mesh = q.device_mesh
    names = axis_names(mesh)
    base = batch_placements(q)
    b, lq, hq, _ = q.shape
    hkv = k.shape[2]
    m = names.index("model") if "model" in names else None
    ntp = 1 if m is None else mesh.size(m)
    hl = hq // ntp
    group = hq // hkv
    by_heads = hq % ntp == 0 and (hkv % ntp == 0 or group % hl == 0)
    if ntp > 1 and (base[m] != Replicate() or not by_heads and lq % ntp):
        q, k, v = batch_split(q), batch_split(k), batch_split(v)
        return batch_split(fn(q, k, v, q_pos, k_pos, **kwargs))

    split, shared = list(base), list(base)
    if ntp > 1:
        split[m] = Shard(2) if by_heads else Shard(1)
        # k and v whole on model: each rank's gradient is a part of the whole.
        shared[m] = Partial()

    def local(t, place, grad):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, place).to_local(grad_placements=grad)

    def kv(t):
        if not by_heads:
            return local(t, base, shared)
        if hkv % ntp == 0:
            return local(t, split, split)
        # The rank's q heads share one kv head: the whole k (v), cut to it.
        lo = mesh.get_local_rank(m) * hl // group
        return local(t, base, shared)[:, :, lo:lo + 1]

    if not by_heads:
        rows = lq // ntp
        lo = mesh.get_local_rank(m) * rows
        q_pos = q_pos[lo:lo + rows]
        if "q_chunk" in kwargs and lq % min(kwargs["q_chunk"], lq) == 0:
            kwargs["q_chunk"] = math.gcd(min(kwargs["q_chunk"], lq), rows)
    o = fn(local(q, split, split), kv(k), kv(v), q_pos, k_pos, **kwargs).contiguous()
    shape = (b, lq, hq, o.shape[3])
    stride = (shape[1] * shape[2] * shape[3], shape[2] * shape[3], shape[3], 1)
    return DTensor.from_local(o, mesh, split, run_check=False, shape=shape, stride=stride)


def placements(spec: P, mesh) -> list:
    """One placement per mesh dim for ``spec``: ``Shard(d)`` on each mesh
    axis that ``spec`` puts on tensor dim ``d``, ``Replicate()`` on the
    rest.  A dim split over several axes must name them in the mesh's
    order, the order in which DTensor splits a dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        assert dims == sorted(dims), (
            f"{spec}: dim {d} is split over {axes}, which the mesh {names} orders "
            "differently")
        for m in dims:
            assert out[m] == Replicate(), f"{spec}: mesh axis {names[m]} used twice"
            out[m] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# Parameter sharding rules.
# ---------------------------------------------------------------------------

def make_activation_policy(mesh, cfg, *, dp=("data",), tp="model") -> ActivationPolicy:
    """Default activation constraints for a (pod?, data, model) mesh."""
    dp = tuple(a for a in dp if a in axis_names(mesh))
    specs = {
        "tokens": P(dp, None),
        # Residual stream: batch on dp, sequence on tp (sequence parallelism).
        "residual": P(dp, tp, None),
        # Block-internal compute: sequence gathered, head/ff dims sharded by
        # the weights.  Like "attn_q"/"attn_kv", repro's default policy
        # constrains no block-internal operand; the kinds stay available.
        "block_compute": P(dp, None, None),
        "logits": P(dp, None, tp),
        "moe_dispatch": P(tp, None, None),   # expert axis -> all-to-all
        "kv_cache": P(None, dp, tp, None, None),  # (L, B, S, H, dh): S on tp
        "ssm_state": P(None, dp, tp, None, None),  # (L, B, H, P, N): H on tp
    }
    return ActivationPolicy(specs=specs, mesh=mesh)


def param_spec(path: tuple[str, ...], ndim: int, cfg, *, dp=("data",), tp="model",
               tp_size: int = 16) -> P:
    """P for a parameter identified by its tree path (``repro``'s rules)."""
    name = "/".join(path)
    f = tuple(dp)  # fsdp axes

    def pad(spec_tail):
        """Left-pad with None for the stacked layer axis if present."""
        return P(*([None] * (ndim - len(spec_tail)) + list(spec_tail)))

    # Embeddings / head.
    if name.endswith("embed"):
        return P(tp, f)
    if name.endswith("lm_head"):
        return P(f, tp)
    if name.endswith("frontend"):
        return P(None, f)
    # Norm scales / small vectors / biases.
    if any(k in name for k in ("norm", "ln", "bias", "a_log", "d_skip", "dt_bias",
                               "bq", "bk", "bv")):
        return pad([f]) if ndim >= 1 else P()
    # MoE.
    if "moe" in name:
        if name.endswith("router"):
            return pad([f, None])
        expert_sharded = cfg.moe_shard == "expert"
        if name.endswith(("wi", "wg")):
            return pad([tp, f, None]) if expert_sharded else pad([None, f, tp])
        if name.endswith("wo"):
            return pad([tp, None, f]) if expert_sharded else pad([None, tp, f])
    # Attention.
    if "attn" in name:
        if not cfg.shard_attn_heads:
            return pad([f, None]) if ndim >= 2 else pad([None])
        if name.endswith(("wq", "wk", "wv")):
            # kv heads may not divide |tp|: shard only q-side on tp.
            if name.endswith("wq") or cfg.n_kv_heads % tp_size == 0:
                return pad([f, tp])
            return pad([f, None])
        if name.endswith("wo"):
            return pad([tp, f])
    # SSM.
    if "ssm" in name:
        if not cfg.shard_ssm_heads:
            return pad([f, None]) if ndim >= 2 else pad([None])
        if name.endswith(("in_xz", "in_dt")):
            return pad([f, tp])
        if name.endswith(("in_b", "in_c")):
            return pad([f, None])
        if name.endswith("conv_x"):
            return pad([None, tp])
        if name.endswith(("conv_b", "conv_c")):
            return pad([None, None])
        if name.endswith("out"):
            return pad([tp, f])
    # Dense MLP.
    if name.endswith(("wi", "wg")):
        return pad([f, tp])
    if name.endswith("wo"):
        return pad([tp, f])
    # Fallback: fully replicated.
    return P(*([None] * ndim))


def params_sharding_tree(params_shape, cfg, mesh, *, dp=("data",), tp="model"):
    """The fitted :class:`P` of every leaf of a parameter tree (tensors, meta
    tensors or anything with a ``shape``) on a ``DeviceMesh`` or a
    ``ShapeMesh``."""
    dp = tuple(a for a in dp if a in axis_names(mesh))
    axis_size = axis_sizes(mesh)
    tp_size = axis_size.get(tp, 1)

    def _fit(spec, shape):
        """Drop sharding on any dim the axes don't divide (e.g. vocab
        50280 % 16, per-head vectors on a 32-way fsdp axis)."""
        out = []
        for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            parts = 1
            for a in axes:
                parts *= axis_size.get(a, 1)
            while axes and dim % parts != 0:
                # Drop the leading (largest-granularity) axis and retry.
                parts //= axis_size.get(axes[0], 1)
                axes = axes[1:]
            if not axes:
                out.append(None)
            else:
                out.append(axes if len(axes) > 1 else axes[0])
        return P(*out)

    def one(path, leaf):
        spec = param_spec(tuple(path.split("/")), len(leaf.shape), cfg, dp=dp, tp=tp,
                          tp_size=tp_size)
        return _fit(spec, tuple(leaf.shape))

    return map_with_path(one, params_shape)


def batch_axes(mesh, batch: int):
    """The data-parallel axes (``pod``, ``data``) for a batch of ``batch``
    rows: all of them where they split it evenly, else None."""
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    sizes = axis_sizes(mesh)
    return dp if batch % math.prod(sizes[a] for a in dp) == 0 else None


def cache_sharding_tree(cache, cfg, mesh, batch: int):
    """The :class:`P` of every leaf of a decode cache (``init_cache``'s) of
    ``batch`` rows: the KV sequence axis on ``model`` (context-parallel
    decode) where it divides, the SSM heads on ``model`` where the config
    shards them, the batch on the data axes where it divides."""
    dp = batch_axes(mesh, batch)
    tp = "model" if "model" in axis_names(mesh) else None
    tp_size = axis_sizes(mesh).get("model", 1)

    def one(name, leaf):
        if name in ("k", "v"):
            # (L, B, S, Hkv, dh): sequence on model (context-parallel).
            tp_ok = tp if leaf.shape[2] % max(tp_size, 1) == 0 else None
            return P(None, dp, tp_ok, None, None)
        if name.startswith("cross_"):
            return P(None, dp, None, None, None)
        if name == "ssm/s":
            return P(None, dp, tp if cfg.shard_ssm_heads else None, None, None)
        if name == "ssm/conv":
            return P(None, dp, None, None)
        return P()  # length scalar

    return map_with_path(one, cache)


def zeros_placed(t, spec: P, mesh, device):
    """Zeros shaped like ``t`` as a DTensor on ``mesh`` placed by ``spec``:
    each rank allocates its own shard only."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    place = placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, place)
    return DTensor.from_local(torch.zeros(local, dtype=t.dtype, device=device), mesh, place,
                              run_check=False, shape=t.shape, stride=t.stride())


def distribute_params(tree, specs, mesh):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` placed by its fitted
    spec in ``specs`` (:func:`params_sharding_tree`'s tree).  Every rank
    holds the same whole leaves (one seed, one checkpoint); each keeps a
    copy of its own shard, with no communication, or the leaf itself where
    its shard is the whole leaf (every split on an axis of size 1)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        place = placements(spec, mesh)
        if all(mesh.size(i) == 1 for i, p in enumerate(place) if p.is_shard()):
            return DTensor.from_local(t.detach(), mesh, place, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t.detach(), mesh, place, src_data_rank=None)

    return tree_map(one, tree, specs)


def shard_params(tree, cfg, mesh):
    """A parameter tree (``init_params``'s, or ``repro``'s through
    ``params_from_numpy``) distributed onto ``mesh`` by ``repro``'s rules:
    :func:`params_sharding_tree` on the mesh's data axes, then
    :func:`distribute_params`."""
    from repro_torch.launch.mesh import dp_axes

    return distribute_params(tree, params_sharding_tree(tree, cfg, mesh, dp=dp_axes(mesh)),
                             mesh)
