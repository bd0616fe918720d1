"""Three-term roofline of one rank's step: the counterpart of
``repro/roofline/analysis.py``.

``repro`` compiles a cell with XLA and sums the per-device shapes of its
post-SPMD HLO.  The port has no HLO: it measures the program it runs, one
rank's eager step.  On a mesh the step runs on meta DTensors over a
``DeviceMesh`` of a fake process group (:func:`fake_process_group`), which
holds the mesh's world size and moves no data, so DTensor makes the
sharding decisions and issues the collectives it would make on cards.
:class:`StepCounter`, a ``TorchDispatchMode``, sees the rank's operations
below DTensor's dispatch (it declines every operation on DTensors, so
DTensor runs it and hands the mode the local operations on the rank's
shards and its collectives), and skips the fake tensors of DTensor's own
shape inference.  Its totals keep ``repro``'s key names (``hlo_`` prefix
included, though there is no HLO) so that the two records line up field
by field:

  * ``hlo_flops_per_dev``: 2·M·N·K of every local matrix product
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``; ``matmul``, ``einsum`` and
    the attention's products reach these), as ``repro`` counts its
    ``dot``s; the backward pass and remat's recomputation included.
  * ``hlo_bytes_per_dev``: the bytes in and out of every local operation,
    views, metadata and allocations skipped, as ``repro`` skips
    ``bitcast``, ``tuple`` and the like.
  * ``collective_bytes_per_dev`` by kind and ``collective_total_per_dev``,
    under ``repro``'s payload convention (per device): an all-gather counts
    its output bytes (what each device receives), an all-reduce 2× its
    operand bytes (ring reduce-scatter + all-gather), a reduce-scatter or
    an all-to-all its operand bytes.  DTensor's functional collectives
    (``_c10d_functional``) and its all-to-all (``_dtensor``), and the c10d
    operations that ``moe_apply_shard_map`` calls (``all_to_all_single``)
    are counted; an operation of these namespaces with no rule here
    raises.

Memory is the eager program's live tensors on the rank, not a compiler's
buffer plan: the arguments' storages are live when the step starts, each
storage an operation makes is live until Python and autograd drop it, and
the peak is the largest sum reached after an operation.  The temporary
that CUDA's softmax backward allocates inside its kernel, below any
dispatch, counts while that operation runs; allocator rounding, library
workspaces and communication buffers are not counted.

Hardware constants: NVIDIA H100 80GB HBM3 at its 700.00 W power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``), NVIDIA's
data sheet figures, not measured: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM,
450 GB/s NVLink one direction a card.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CARD", "COLLECTIVES", "StepCounter",
           "roofline_terms", "model_flops", "count_step", "analyze_step", "fake_process_group",
           "in_fake_group", "fake_mesh"]

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12      # bf16 dense, a card (data sheet)
HBM_BW = 3.35e12         # bytes/s, a card (data sheet)
LINK_BW = 450e9          # bytes/s, NVLink one direction, a card (data sheet)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_PRODUCTS = frozenset((_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                       _aten.baddbmm.default))
# No traffic: allocations, views the schema does not mark as aliases, and
# a Python number made a tensor (a host constant where the tensors live on a
# card; ``repro`` skips ``constant``).
_NO_TRAFFIC = frozenset((_aten.empty.memory_format, _aten.empty_strided.default,
                         _aten.empty_like.default, _aten._unsafe_view.default,
                         _aten.lift_fresh.default, _aten.scalar_tensor.default))
# CUDA kernels that allocate a temporary inside the kernel, below any
# dispatch, of their first input's size: the softmax backward (ATen's
# ``SoftMax.cu`` computes ``grad * output`` before its reduction).
_KERNEL_TEMPORARY = frozenset((_aten._softmax_backward_data.default,))
# Collectives whose operands are the tensor arguments and whose outputs are
# the returned tensors: the functional ones, and the all-to-all that DTensor
# issues on a card's mesh for a split moved from one dim to another.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# c10d operations: (kind, index of the operand argument, index of the output).
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")
_COMM_METADATA = frozenset(("wait_tensor", "_wrap_tensor_autograd", "mesh_get_process_group"))


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


class StepCounter(TorchDispatchMode):
    """Counts one rank's local operations while active: FLOPs of the matrix
    products, bytes in and out, collective payloads (and calls) by kind, and
    the live bytes of the storages it has seen, with their peak.  Call
    :meth:`hold` on the step's arguments before it runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.coll: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._held = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s local tensors as live (those not
        yet seen); returns the bytes of all its distinct storages."""
        from torch.distributed.tensor import DTensor

        seen, total = set(), 0
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            total += st.nbytes()
            if st not in self._held:
                self._held[st] = True
                self.live += st.nbytes()
                weakref.finalize(st, self._free, st.nbytes())
        self.peak = max(self.peak, self.live)
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it and hands back the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                 # DTensor's shape inference, not the rank's work
        self.hold(outs)
        ns, name = func.namespace, func._opname
        if ns in _COMM_NAMESPACES:
            self._collective(func, ns, name, args, ins, outs)
            return out
        if func in _NO_TRAFFIC or _is_view(func) or not outs:
            return out
        if func in _KERNEL_TEMPORARY:
            # Alive while the kernel runs, written once and read once.
            temp = _nbytes(ins[:1])
            self.peak = max(self.peak, self.live + temp)
            self.traffic += 2 * temp
        if func in _PRODUCTS:
            k = ins[-1].shape[-2]          # the contracted dim of the last operand
            self.flops += 2.0 * outs[0].numel() * k
        self.traffic += _nbytes(ins) + _nbytes(outs)
        return out

    def _collective(self, func, ns, name, args, ins, outs) -> None:
        if name in _COMM_METADATA:
            return
        if ns == "c10d" and name in _C10D:
            kind, i_in, i_out = _C10D[name]
            ins, outs = _tensors(args[i_in]), _tensors(args[i_out])
        elif ns != "c10d" and name in _FUNCTIONAL:
            kind = _FUNCTIONAL[name]
        else:
            raise NotImplementedError(f"{func}: no payload rule for this collective")
        in_b, out_b = _nbytes(ins), _nbytes(outs)
        payload = out_b if kind == "all-gather" else 2 * in_b if kind == "all-reduce" else in_b
        self.coll[kind] += payload
        self.calls[kind] += 1
        self.traffic += in_b + out_b

    def totals(self) -> dict:
        """``repro``'s ``hlo_totals`` keys, and the collective calls by kind."""
        return {
            "hlo_flops_per_dev": self.flops,
            "hlo_bytes_per_dev": self.traffic,
            "collective_bytes_per_dev": dict(self.coll),
            "collective_total_per_dev": sum(self.coll.values()),
            "collective_calls_per_dev": dict(self.calls),
        }


def roofline_terms(totals: dict) -> dict:
    compute_s = totals["hlo_flops_per_dev"] / PEAK_FLOPS
    memory_s = totals["hlo_bytes_per_dev"] / HBM_BW
    coll_s = totals["collective_total_per_dev"] / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = compute_s / bound if bound > 0 else 0.0
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "roofline_fraction": frac,   # compute-term share of the bound
    }


def model_flops(cfg, spec, *, backward: bool) -> float:
    """6·N_active·D (train) or 2·N_active·D (inference) — global."""
    n = cfg.active_param_count()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n * tokens
    tokens = spec.global_batch  # one token per sequence
    return 2.0 * n * tokens


def count_step(fn, args) -> dict:
    """Run ``fn(*args)`` once under a :class:`StepCounter`: its totals, and
    the rank's ``argument_size_in_bytes``, ``output_size_in_bytes`` and
    ``peak_memory_in_bytes`` (of live tensors, the arguments included).
    The caller installs the activation policy."""
    counter = StepCounter()
    arg_bytes = counter.hold(args)
    with counter:
        out = fn(*args)
    return {**counter.totals(), "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": counter.hold(out), "peak_memory_in_bytes": counter.peak}


def analyze_step(fn, args, cfg, spec, mesh) -> dict:
    """:func:`count_step`, and the cell's record: ``repro``'s
    ``analyze_compiled`` keys (the totals, the three terms, ``chips``,
    ``model_flops_global``, ``useful_flops_ratio``) and rank 0's memory,
    ``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``peak_memory_in_bytes`` and ``temp_size_in_bytes`` (the peak less the
    arguments).  ``mesh`` is the ``DeviceMesh`` the arguments live on, or
    None for plain tensors on one device.  ``model_flops`` takes the ``cfg``
    given, the cell's own."""
    counted = count_step(fn, args)
    chips = 1 if mesh is None else math.prod(mesh.shape)
    mf = model_flops(cfg, spec, backward=spec.kind == "train")
    return {
        **counted,
        **roofline_terms(counted),
        "chips": chips,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / chips / max(counted["hlo_flops_per_dev"], 1.0),
        "temp_size_in_bytes": counted["peak_memory_in_bytes"]
        - counted["argument_size_in_bytes"],
    }


@contextlib.contextmanager
def fake_process_group(world: int):
    """The default process group for the block: a fake group of ``world``
    ranks, this process rank 0, whose collectives move nothing.  Raises in
    a process that already has a group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the fake group "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def in_fake_group() -> bool:
    """Whether the default process group is a fake one."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend() == "fake"


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on the first ranks of the
    fake default group (:func:`fake_process_group`), of the cards' device
    type: DTensor moves a split from one dim to another by an all-to-all on
    cards and by an all-gather on a CPU mesh (gloo has no all-to-all)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not in_fake_group():
        raise RuntimeError("fake_mesh needs a fake default group (fake_process_group)")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the fake group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh("cuda", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
