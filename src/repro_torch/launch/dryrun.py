"""Dry run of every (architecture x input shape x mesh) cell, without a
card: a port of ``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite3_2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch

The reference lowers and compiles each cell's step for 256 or 512 forced
host devices and reads XLA's memory and cost analyses.  The port runs the
real step (``make_train_step``'s training step, ``Model.prefill``,
``Model.decode_step``) on the ``meta`` device, where tensors have shapes and
no memory, at one data-parallel replica's batch (``global_batch / dp``,
the whole batch where dp does not divide it, as the sharding rules
replicate it then).  The kernels' fake versions stand in for their launches
(``kernels/*/ops.py``), so the trace takes the card's path.  Around it:

* :class:`StepTrace` counts the flops as ``FlopCounterMode`` counts them
  (the matrix products and, by their flop formulas, the kernels' own
  operations), follows every storage the step allocates to its death (the
  peak of live bytes), and sums the bytes each aten op reads and writes
  (views and allocations excluded);
* the sharding rules (``dist/sharding.py``) give the arguments'
  per-device bytes over a stand-in mesh of the production layout, whose
  positions are ``meta`` devices, and the FSDP collectives
  (``launch/roofline.py::collectives_from_specs``).

A cell that fails to trace is a bug, as in the reference: a kernel with no
fake version, a spec that does not fit, a head dim above 256.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, config_for
from repro_torch.dist.sharding import (PartitionSpec, batch_specs, cache_specs,
                                       data_axis_size, param_specs)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.roofline import (Roofline, collectives_from_specs, model_flops_decode,
                                         model_flops_train)
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.model_zoo import (build_model, input_specs, memory_len_for,
                                          shape_supported)
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.train_loop import TrainState, make_train_step
from repro_torch.tree import tree_leaves, tree_map

#: the stand-in meshes: the production layouts, and one card
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}

#: how the record's figures are derived where the reference's come from XLA
DERIVED = (
    "traced on the meta device at one data-parallel replica's batch "
    "(lower_s: the trace's seconds; compile_s 0: nothing compiles). "
    "flops: FlopCounterMode's formulas over the step (matrix products and the "
    "kernels' own; elementwise work not counted) over the model axis. hbm_bytes: "
    "each aten op's tensor inputs and outputs (views and allocations "
    "excluded) over the model axis. argument_bytes: param_specs, batch_specs "
    "and cache_specs on the stand-in mesh. per_device_total: the traced peak "
    "of live bytes, arguments included (eager PyTorch: a training step holds "
    "the old and the new state at once); tensors derived from an argument "
    "by ops without a flop formula (bf16 casts, gradients the optimizer "
    "combines with the moments, the new state, new cache entries; traced by "
    "provenance, not by shape) at that argument's shard size, activations and "
    "temporaries as traced, not split over the model axis (an upper bound); "
    "the ssd backward's scratch counted while its launch runs. temp_bytes = "
    "per_device_total - argument - output + alias. collectives: FSDP only "
    "(collectives_from_specs); tensor parallelism over the model axis not "
    "counted.")


def stand_in_mesh(name: str) -> Mesh:
    """A mesh of the production layout ``name`` whose positions are
    ``meta`` devices (the sharding rules read only its shape)."""
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, ["meta"] * math.prod(shape))


def _serving_dtype(params):
    """Serving deployments store bf16 weights (inference checkpoints)."""
    return tree_map(lambda t: t.to(torch.bfloat16)
                    if t.dtype == torch.float32 and t.dim() >= 2 else t, params)


RESIDUAL_BUDGET = 4 * 2**30  # per-device budget for the remat carry stack


def auto_microbatches(cfg, shape, dp: int) -> int:
    """Smallest microbatch count whose remat residual stack
    (n_repeats × B_local × S × D × 6 B, the bf16+f32 stacking) fits the
    budget.  Must divide the global batch and keep B/mb ≥ dp."""
    reps = cfg.n_repeats + cfg.n_encoder_layers
    for mb in (1, 2, 4, 8, 16):
        if shape.global_batch % mb or (shape.global_batch // mb) % dp:
            continue
        b_local = shape.global_batch // mb // dp
        stack = reps * b_local * shape.seq_len * cfg.d_model * 6
        if stack <= RESIDUAL_BUDGET:
            return mb
    return 16


@dataclasses.dataclass
class Step:
    """A cell's real step over its arguments: ``run()`` runs it once.
    ``arguments`` maps ``state`` / ``params``, ``batch`` and ``cache`` to
    their trees; ``donated`` names the one the step donates (the training
    state, the decode cache) or is None."""
    run: Callable[[], object]
    arguments: dict
    donated: str | None


def make_step(cfg: ArchConfig, shape: ShapeConfig, batch: int, device,
              generator: torch.Generator, microbatches: int = 1,
              remat: bool = True) -> Step:
    """The step of ``shape``'s kind at ``batch`` sequences on ``device``:
    the training step with AdamW state, the prefill of ``Model.prefill``
    or one decode step over a full cache, on parameters drawn from
    ``generator`` (bf16 copies of the float32 ones of 2 dims or more for
    serving) and zero inputs."""
    S = shape.seq_len
    model = build_model(cfg, device)
    mem_len = memory_len_for(cfg, shape)
    if shape.kind != "decode":
        tokens = torch.zeros((batch, S), dtype=torch.int32, device=device)
        memory = ({"memory": torch.zeros((batch, mem_len, cfg.d_model), dtype=torch.bfloat16,
                                         device=device)} if mem_len else {})
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        params = T.init_params(generator, cfg, device)
        state = TrainState(params, adamw_init(params, opt_cfg))
        data = {"tokens": tokens, "labels": torch.zeros_like(tokens), **memory}
        fn = make_train_step(model, opt_cfg, microbatches=microbatches, remat=remat)
        return Step(lambda: fn(state, data), {"state": state, "batch": data}, "state")
    params = _serving_dtype(T.init_params(generator, cfg, device))
    model.load(params)
    if shape.kind == "prefill":
        data = {"tokens": tokens, **memory}
        return Step(lambda: model.prefill(tokens, data.get("memory"), max_len=S),
                    {"params": params, "batch": data}, None)
    cache = model.init_cache(batch, S, mem_len)
    cache["pos"] = S - 1  # a step over a full cache
    step_tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    return Step(lambda: model.decode_step(cache, step_tokens),
                {"params": params, "cache": cache, "batch": {"tokens": step_tokens}}, "cache")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _shards(spec: PartitionSpec, mesh) -> int:
    axes = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
    return math.prod(mesh.shape[a] for a in axes)


def _scratch_bytes(func, args) -> int:
    """Bytes a kernel launch allocates and frees inside itself, which its
    fake does not return: the ssd backward's scratch."""
    if func is torch.ops.repro_torch.ssd_scan_bwd.default:
        from repro_torch.kernels.ssd_scan.ops import fake_backward_buffers

        xdt, B, n_rep = args[0], args[2], args[4]
        return sum(t.nbytes for t in fake_backward_buffers(xdt.to("meta"), B.to("meta"),
                                                           n_rep)[4:])
    return 0


_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
                torch.ops.aten._unsafe_view, torch.ops.aten.lift_fresh}


def _whole(t: torch.Tensor) -> bool:
    """``t`` spans its whole storage (not a slice of a larger tensor)."""
    return t.numel() * t.element_size() == t.untyped_storage().nbytes()


def _flat_tensors(items) -> list[torch.Tensor]:
    """The tensors among an op's arguments or outputs (a tensor list one
    level down, as ``cat`` takes)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class StepTrace(TorchDispatchMode):
    """Over every op dispatched inside it: :attr:`flops`, by the formulas
    ``FlopCounterMode`` takes (``torch.utils.flop_counter``'s registry,
    the kernels' own among them); :attr:`hbm_bytes`, the bytes of each
    op's tensor inputs and outputs, views and allocations excluded; and the
    peak of live bytes (:attr:`peak`) over the storages first seen as an
    op's output, each counted until it dies.

    A storage's bytes on one device follow where it comes from, not its
    shape.  :meth:`argument` registers a storage that exists before the
    step (a parameter, a moment, a cache leaf) with its bytes on one
    device.  An op with no flop formula (elementwise work, casts, copies,
    in-place updates) joins each output with every input of the same shape
    where both span their whole storage:
    a bf16 cast of a parameter, a gradient that the optimizer combines with
    the moments, the new parameters and moments and a new cache entry end
    up in an argument's group and count at its share (the smallest share
    where a group holds several).  Everything else (activations, matrix
    products' outputs, temporaries) counts in full.  The groups are known
    only once the step has run, so the trace records when each storage is
    born and dies and :attr:`peak` replays that record."""

    def __init__(self):
        super().__init__()
        self.node_of = WeakIdKeyDictionary()  # storage -> its node
        self.nbytes: list[float] = []  # node -> its bytes as traced
        self.share: list[float | None] = []  # node -> an argument's bytes on one device
        self.parent: list[int] = []  # node -> its group (union-find)
        self.events: list[tuple[int, int]] = []  # (node, +1 born / -1 died / 0 op's end)
        self.scratch: list[int] = []  # at each op's end, its launch's own scratch bytes
        self.hbm_bytes = self.flops = 0
        self.depth = 0  # the mode's nesting (it enters itself to decompose an op)
        self._divisor_of: dict | None = None
        self._kinds: dict = {}  # op -> "decompose", "view" (moves no bytes) or "moves"

    def _node(self, st) -> int:
        node = self.node_of.get(st)
        if node is None:
            node = self.node_of[st] = len(self.nbytes)
            self.nbytes.append(float(st.nbytes()))
            self.share.append(None)
            self.parent.append(node)
        return node

    def _root(self, node: int) -> int:
        while self.parent[node] != node:
            self.parent[node] = node = self.parent[self.parent[node]]
        return node

    def _join(self, a: int, b: int) -> None:
        a, b = self._root(a), self._root(b)
        if a != b:
            self.parent[b] = a

    def argument(self, t: torch.Tensor, nbytes: float) -> None:
        self.share[self._node(t.untyped_storage())] = nbytes

    def device_bytes(self, node: int) -> float:
        """A node's bytes on one device: an argument's as registered, a
        storage in an argument's group at that group's share."""
        if self.share[node] is not None:
            return self.share[node]
        divisor = self._divisors().get(self._root(node), 1.0)
        return self.nbytes[node] / divisor

    def _divisors(self) -> dict:
        if self._divisor_of is None:
            out: dict = {}
            for node, share in enumerate(self.share):
                if share:
                    root = self._root(node)
                    out[root] = min(out.get(root, math.inf), self.nbytes[node] / share)
            self._divisor_of = out
        return self._divisor_of

    def bytes_of_tensors(self, tensors) -> float:
        """The bytes on one device of the distinct storages under
        ``tensors``."""
        nodes = {self._node(t.untyped_storage()) for t in tensors}
        return sum(self.device_bytes(n) for n in nodes)

    @property
    def peak(self) -> float:
        """The most bytes on one device that storages born in the step held
        at any op's end, its launch's scratch included."""
        live = peak = 0.0
        ends = iter(self.scratch)
        for node, what in self.events:
            if what:
                live += what * self.device_bytes(node)
            else:
                peak = max(peak, live + next(ends))
        return peak

    def _died(self, node: int) -> None:
        if self.depth:
            self.events.append((node, -1))

    def __enter__(self):
        self.depth += 1
        self._divisor_of = None
        return super().__enter__()

    def __exit__(self, *exc):
        self.depth -= 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = (
                "decompose" if formula is None and torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
                else "view" if func.is_view or packet in _ALLOCATIONS else "moves")
        if kind == "decompose":
            # as FlopCounterMode does: an op that reaches here undecomposed
            # (under inference_mode, matmul) is counted by its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _flat_tensors(out if isinstance(out, (list, tuple)) else (out,))
        ins = _flat_tensors(args) + _flat_tensors(kwargs.values())
        if kind == "moves":
            self.hbm_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs if not func.is_view else ():  # a view's storage is its input's
            st = t.untyped_storage()
            if st not in self.node_of:
                node = self._node(st)
                self.events.append((node, 1))
                weakref.finalize(st, self._died, node)
        if kind == "moves" and formula is None:
            for o in filter(_whole, outs):
                for t in ins:
                    if t.shape == o.shape and _whole(t):
                        self._join(self._node(o.untyped_storage()),
                                   self._node(t.untyped_storage()))
        self.events.append((-1, 0))
        self.scratch.append(_scratch_bytes(func, args))
        return out


def _spec_leaves(specs) -> list[PartitionSpec]:
    """The specs of a spec tree in leaf order (a spec is a tuple, so the
    port's ``tree_leaves`` would walk into it)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    if isinstance(specs, (list, tuple)):
        return [x for v in specs for x in _spec_leaves(v)]
    return []


def _argument_leaves(cfg, shape: ShapeConfig, step: Step, mesh) -> dict:
    """For each argument of ``step``, its tensors with their bytes on one
    device: parameters and moments by ``param_specs``; the batch and the
    cache by ``batch_specs`` and ``cache_specs`` at the global shapes of
    :func:`input_specs` (the replica's tensors are their slices)."""
    glob = input_specs(cfg, shape)
    out = {}
    for name, tree in step.arguments.items():
        if name in ("state", "params"):
            params = tree.params if name == "state" else tree
            p = _spec_leaves(param_specs(params, mesh, cfg))
            leaves = _tensors(params)
            if name == "state":
                leaves += _tensors(tree.opt["m"]) + _tensors(tree.opt["v"]) + [tree.opt["step"]]
                p = p * 3 + [PartitionSpec()]
            full, specs = leaves, p
        elif name == "cache":
            pairs = [(t, s) for t, s in zip(tree_leaves(glob["cache"]),
                                            _spec_leaves(cache_specs(glob["cache"], mesh, cfg)),
                                            strict=True) if isinstance(t, torch.Tensor)]
            full, specs = [t for t, _ in pairs], [s for _, s in pairs]
            leaves = _tensors(tree)
        else:
            g = {k: glob[k] for k in tree}
            full, specs, leaves = _tensors(g), _spec_leaves(batch_specs(g, mesh, cfg)), \
                _tensors(tree)
        out[name] = [(t, f.numel() * f.element_size() / _shards(s, mesh))
                     for t, f, s in zip(leaves, full, specs, strict=True)]
    return out


def trace_step(cfg, shape: ShapeConfig, step: Step, mesh) -> dict:
    """Run ``step`` once under a :class:`StepTrace`:
    the replica's flops and bytes accessed, the trace's seconds, and the
    per-device memory (the record's ``memory``)."""
    arguments = _argument_leaves(cfg, shape, step, mesh)
    tracer = StepTrace()
    for leaves in arguments.values():
        for t, nbytes in leaves:
            tracer.argument(t, nbytes)
    arg_bytes = {name: tracer.bytes_of_tensors([t for t, _ in leaves])
                 for name, leaves in arguments.items()}
    t0 = time.perf_counter()
    with tracer:
        out = step.run()
    seconds = time.perf_counter() - t0
    if isinstance(out[0], TrainState):
        out = (out[0].params, out[0].opt, out[1])
    argument = sum(arg_bytes.values())
    output = tracer.bytes_of_tensors(_tensors(out))
    alias = arg_bytes[step.donated] if step.donated else 0.0
    total = argument + tracer.peak
    return {"seconds": seconds, "flops": tracer.flops,
            "hbm_bytes": tracer.hbm_bytes, "memory": {
                "argument_bytes": int(argument), "output_bytes": int(output),
                "temp_bytes": int(total - argument - output + alias),
                "alias_bytes": int(alias), "per_device_total": int(total)}}


def _param_tree(step: Step):
    state = step.arguments.get("state")
    return state.params if state is not None else step.arguments["params"]


def dryrun_cell(arch: str, shape_name, multi_pod: bool = False, microbatches: int = 0,
                remat: bool = True, int8_kv: bool = False, mesh_name: str | None = None,
                cfg: ArchConfig | None = None) -> dict:
    """One cell's record.  ``shape_name`` names a shape of ``SHAPES`` or is
    a ``ShapeConfig``; ``mesh_name`` (a key of :data:`MESHES`) overrides
    ``multi_pod``; ``cfg`` overrides ``config_for(arch)``; ``microbatches``
    0 picks :func:`auto_microbatches`."""
    cfg = cfg or config_for(arch)
    if int8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_name = mesh_name or ("2x16x16" if multi_pod else "16x16")
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "status": "skip"}
    ok, why = shape_supported(cfg, shape)
    if not ok:
        rec["reason"] = why
        return rec

    mesh = stand_in_mesh(mesh_name)
    chips = math.prod(mesh.shape.values())
    dp = data_axis_size(mesh)
    model_size = mesh.shape["model"]
    if microbatches == 0 and shape.kind == "train":
        microbatches = auto_microbatches(cfg, shape, dp)
    rec["microbatches"] = microbatches if shape.kind == "train" else None
    batch = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
    step = make_step(cfg, shape, batch, "meta", torch.Generator("cpu").manual_seed(0),
                     microbatches=max(microbatches, 1), remat=remat)
    traced = trace_step(cfg, shape, step, mesh)

    params = _param_tree(step)
    p_specs = _spec_leaves(param_specs(params, mesh, cfg))
    uses = microbatches * (3 if remat else 2) if shape.kind == "train" else 1
    colls, link_bw = collectives_from_specs(_tensors(params), p_specs, mesh, uses=uses,
                                            reduce_grads=shape.kind == "train")
    if shape.kind == "train":
        flops_model = model_flops_train(cfg, shape.global_batch * shape.seq_len)
    elif shape.kind == "prefill":
        flops_model = 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    else:
        flops_model = model_flops_decode(cfg, shape.global_batch)
    roof = Roofline(traced["flops"] / model_size, traced["hbm_bytes"] / model_size,
                    colls.total_bytes, chips, link_bw)
    rec.update(
        status="ok",
        lower_s=round(traced["seconds"], 2),
        compile_s=0.0,
        replica_batch=batch,
        memory=traced["memory"],
        roofline=roof.as_dict(),
        collectives={"bytes": colls.bytes_by_kind, "count": colls.count_by_kind},
        model_flops_global=flops_model,
        model_flops_per_chip=flops_model / chips,
        useful_flop_ratio=flops_model / chips / roof.flops if roof.flops else None,
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        derived=DERIVED,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=0)  # 0 = auto
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 KV cache variant (§Perf)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}.{shape}.{'multi' if multi else 'single'}"
                if args.int8_kv:
                    tag += ".int8kv"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = dryrun_cell(arch, shape, multi,
                                      microbatches=args.microbatches,
                                      remat=not args.no_remat,
                                      int8_kv=args.int8_kv)
                except Exception as e:  # a failed cell is recorded, and the run fails at the end
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if multi else "16x16",
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    m = rec["memory"]["per_device_total"] / 2**30
                    d = rec["roofline"]["dominant"]
                    extra = (f" mem/dev={m:.2f}GiB dom={d} "
                             f"trace={rec['lower_s']:.0f}s")
                elif status == "fail":
                    extra = " " + rec["error"][:120]
                print(f"[{status:4s}] {tag}{extra}", flush=True)
                gc.collect()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
