"""Port of ``src/repro/core/executor.py:1-935``: the set-oriented plan
executor, on torch tensors.

* **Selection vectors, not compaction** — a plan value is a
  :class:`MaskedTable` (full-width columns + bool row mask).  Filters AND
  into the mask; no operator has a data-dependent output shape, and no
  operator reads a device value back to the host (no ``.item()``), so a
  plan's kernels queue on the device without host syncs.
* **Joins** — sort + ``searchsorted`` on the key-unique build side.
* **Group-by** — sort-based segmenting with ``index_add_`` /
  ``scatter_reduce_`` into a static group capacity, the stats-driven dense
  key path, or the hand-written relagg kernel (``policy.pallas_agg``).
* **CSE for free** — node results are memoized per execution.
* **Rewritten cursor loops** (``LoopScan``, reference ``:673-784``) — the
  reduce kind is a masked sum/product over the relation; the scan kind
  steps the relation's rows in order on the host, one predicated step
  list a row, and makes no host sync.
* **Correlated scalar subqueries** (reference ``:787-816``) —
  ``torch.func.vmap`` of the subplan over the outer rows; no loop over
  them.  An operator that cannot batch raises ``NotImplementedError``
  naming ROADMAP A3.1, as do the correlated Apply over a general subplan
  (the reference's ``_exec_vmap_apply``) and the correlated EXISTS.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.tables.table import Column, Table, resolve_device

_F32_MAX = float(torch.finfo(torch.float32).max)
_I32_MAX = int(torch.iinfo(torch.int32).max)


@dataclasses.dataclass
class MaskedTable:
    table: Table
    mask: torch.Tensor  # bool (n,)

    @property
    def num_rows(self) -> int:
        return int(self.mask.shape[0])

    def env(self) -> dict[str, S.Value]:
        return {
            n: S.Value(c.data, c.valid, c.dictionary)
            for n, c in self.table.columns.items()
        }

    def compact(self) -> Table:
        """Materialization of the selected rows (reads the mask on the
        host; used only at result-delivery time)."""
        idx = torch.nonzero(self.mask).reshape(-1)
        return self.table.gather(idx)


def _value_to_column(v: S.Value, n: int) -> Column:
    b = v.broadcast(n)
    return Column(b.data, b.valid, b.dictionary)


def _scalar_value(v: S.Value) -> S.Value:
    """Coerce a Value to scalar (shape ``()``) leaves — loop-carry state
    is rank-0 regardless of how broadcasting shaped the evaluation."""
    d = v.data
    if d.dim() > 0:
        d = d.reshape(-1)[0]
    val = v.validity()
    if val.dim() > 0:
        val = val.reshape(-1)[0]
    return S.Value(d, val, v.dictionary)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-d index tensor, as a gather on the device (an
    index of Python's ``[]`` may be read back to the host)."""
    return x.index_select(0, idx.reshape(1)).reshape(x.shape[1:])


def _batched(*tensors: torch.Tensor) -> bool:
    """True when a tensor carries a ``torch.func.vmap`` batch axis."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in tensors)


def _a31(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A3.1: correlated Apply, "
        "EXISTS and GroupAgg under torch.func.vmap)")


def _sort_key_for(col: Column, mask: torch.Tensor) -> torch.Tensor:
    """Key array with masked/NULL rows pushed to the end (+inf sentinel)."""
    data = col.data
    ok = mask & col.validity()
    if data.is_floating_point():
        return torch.where(ok, data, _F32_MAX)
    return torch.where(ok, data.to(torch.int32), _I32_MAX)


def _stable_order(keys: torch.Tensor) -> torch.Tensor:
    if keys.dtype == torch.bool:
        keys = keys.to(torch.uint8)
    return torch.argsort(keys, stable=True)


def _run_starts(sorted_keys: list[torch.Tensor], n: int, device) -> torch.Tensor:
    """Bool (n,): True where a run of equal key tuples starts (row 0
    always starts one) — the reference's ``.at[0].set(True)`` boundaries."""
    newgrp = torch.zeros((n,), dtype=torch.bool, device=device)
    for sk in sorted_keys:
        newgrp = newgrp | (sk != torch.roll(sk, 1))
    if n:
        newgrp[0] = True
    return newgrp


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    # torch.cumsum of int32 yields int64; the reference's stays int32
    return torch.cumsum(x.to(torch.int32), 0).to(torch.int32)


def _union_dense_rank(left: "MaskedTable", right: "MaskedTable", on):
    """Composite-key equality via one synthetic int32 key per side.

    Lexicographically sorts the *union* of both sides' key tuples
    (stable argsort composition, least-significant key first), marks run
    boundaries, and cumsums them into dense group ids — equal tuples get
    equal ids regardless of side, so the ordinary single-key sort-merge
    applies.  Rows with any masked/NULL key component map to the int32
    sentinel and never match (matching single-key NULL semantics)."""
    nl = left.num_rows
    n = nl + right.num_rows
    device = left.mask.device
    parts = []
    lvalid = left.mask
    rvalid = right.mask
    for lc, rc in on:
        lk = left.table.columns[lc]
        rk = right.table.columns[rc]
        lvalid = lvalid & lk.validity()
        rvalid = rvalid & rk.validity()
        a, b = _sort_key_for(lk, left.mask), _sort_key_for(rk, right.mask)
        kt = torch.promote_types(a.dtype, b.dtype)
        parts.append(torch.cat([a.to(kt), b.to(kt)]))
    order = torch.arange(n, device=device)
    for u in reversed(parts):
        order = order[_stable_order(u[order])]
    newgrp = _run_starts([u[order] for u in parts], n, device)
    gid = torch.zeros((n,), dtype=torch.int32, device=device).scatter(
        0, order, _cumsum_i32(newgrp) - 1
    )
    lkeys = torch.where(lvalid, gid[:nl], _I32_MAX)
    rkeys = torch.where(rvalid, gid[nl:], _I32_MAX)
    return lkeys, rkeys


def _segment_sum(vals: torch.Tensor, gid: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``gid`` is in [0, num).  Float sums
    accumulate in float64 and round once to the input's dtype: on CUDA
    ``index_add_`` adds with atomics in a run-dependent order, and a float32
    running sum over a 1.5M-row group (TPC-H Q1 at SF 1) drifts by ~1e-4
    relative from run to run."""
    acc = torch.float64 if vals.is_floating_point() else vals.dtype
    out = torch.zeros((num,), dtype=acc, device=vals.device)
    return out.index_add_(0, gid, vals.to(acc)).to(vals.dtype)


def _segment_extreme(vals: torch.Tensor, gid: torch.Tensor, num: int,
                     reduce: str) -> torch.Tensor:
    """``jax.ops.segment_min``/``segment_max``: an empty segment keeps the
    reference's identity (+-inf for floats, the integer extremes)."""
    if vals.is_floating_point():
        fill = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(vals.dtype)
        fill = info.max if reduce == "amin" else info.min
    out = torch.full((num,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, gid.to(torch.int64), vals, reduce=reduce,
                               include_self=True)


class Executor:
    """Evaluates relational plans over a catalog of named Tables on
    ``device`` (``None`` means the card)."""

    def __init__(
        self,
        catalog: dict[str, Table],
        udf_column_evaluator: Callable | None = None,
        use_pallas_agg: bool = False,
        device=None,
    ):
        self.catalog = catalog
        # froid-OFF hook: computes a whole column by iterating the UDF per
        # row (Interpreter.eval_udf_call)
        self.udf_column_evaluator = udf_column_evaluator
        self.use_pallas_agg = use_pallas_agg
        self.device = resolve_device(device)
        self._stats = {"bytes_scanned": 0, "rows_scanned": 0}

    @property
    def stats(self) -> dict:
        """Logical-read counters (copy; accumulates across executions)."""
        return dict(self._stats)

    def _ctx(self, n: int, ctx) -> S.EvalContext:
        return S.EvalContext(self, n, ctx.params, ctx.outer, ctx.vars,
                             self.device)

    def _sub_executor(self) -> "Executor":
        """Executor used for nested plan evaluation (correlated scalar
        subqueries)."""
        return Executor(self.catalog, self.udf_column_evaluator,
                        self.use_pallas_agg, self.device)

    # -- public API --------------------------------------------------------
    def execute(self, plan: R.RelNode, params=None, outer=None, vars=None) -> MaskedTable:
        ctx = S.EvalContext(
            executor=self, params=params or {}, outer=outer or {},
            vars=vars or {}, device=self.device,
        )
        memo: dict[int, MaskedTable] = {}
        return self._exec(plan, ctx, memo)

    # -- node dispatch -----------------------------------------------------
    def _exec(self, node: R.RelNode, ctx, memo) -> MaskedTable:
        key = node.node_id
        if key in memo:
            return memo[key]
        out = self._exec_node(node, ctx, memo)
        memo[key] = out
        return out

    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bool, device=self.device)

    def _exec_node(self, node: R.RelNode, ctx, memo) -> MaskedTable:
        if isinstance(node, R.Scan):
            t = self.catalog[node.table]
            self._stats["bytes_scanned"] += t.nbytes()
            self._stats["rows_scanned"] += t.num_rows
            return MaskedTable(t, self._ones(t.num_rows))

        if isinstance(node, R.ConstantScan):
            return MaskedTable(Table({}), self._ones(1))

        if isinstance(node, R.Compute):
            child = self._exec(node.child, ctx, memo)
            n = child.num_rows
            env = child.env()
            cctx = self._ctx(n, ctx)
            cctx.row_mask = child.mask  # for subquery short-circuits
            table = child.table
            for name, expr in node.computed.items():
                v = S.eval_scalar(expr, env, cctx)
                col = _value_to_column(v, n)
                table = table.with_column(name, col)
                env[name] = S.Value(col.data, col.valid, col.dictionary)
            return MaskedTable(table, child.mask)

        if isinstance(node, R.Project):
            child = self._exec(node.child, ctx, memo)
            cols = {new: child.table.columns[old] for new, old in node.cols.items()}
            return MaskedTable(Table(cols), child.mask)

        if isinstance(node, R.Filter):
            child = self._exec(node.child, ctx, memo)
            cctx = self._ctx(child.num_rows, ctx)
            cctx.row_mask = child.mask
            v = S.eval_scalar(node.pred, child.env(), cctx)
            b = v.broadcast(child.num_rows)
            pred = b.data.to(torch.bool) & b.validity()  # NULL -> false
            return MaskedTable(child.table, child.mask & pred)

        if isinstance(node, R.Join):
            return self._exec_join(node, ctx, memo)

        if isinstance(node, R.Apply):
            return self._exec_apply(node, ctx, memo)

        if isinstance(node, R.GroupAgg):
            return self._exec_groupagg(node, ctx, memo)

        if isinstance(node, R.LoopScan):
            return self._exec_loopscan(node, ctx, memo)

        if isinstance(node, R.Sort):
            child = self._exec(node.child, ctx, memo)
            n = child.num_rows
            order = torch.arange(n, device=self.device)
            for colname, asc in reversed(node.keys):
                col = child.table.columns[colname]
                k = _sort_key_for(col, child.mask)[order]
                if not asc:
                    big = _F32_MAX if k.is_floating_point() else _I32_MAX
                    k = torch.where(k == big, k, -k)
                order = order[_stable_order(k)]
            # push masked-out rows last regardless of key values
            order = order[_stable_order(~child.mask[order])]
            t = child.table.gather(order)
            m = child.mask[order]
            if node.limit is not None:
                m = m & (torch.arange(n, device=self.device) < node.limit)
            return MaskedTable(t, m)

        raise TypeError(f"unknown plan node {type(node).__name__}")

    # -- join --------------------------------------------------------------
    def _exec_join(self, node: R.Join, ctx, memo) -> MaskedTable:
        left = self._exec(node.left, ctx, memo)
        right = self._exec(node.right, ctx, memo)

        if len(node.on) == 1:
            lcol, rcol = node.on[0]
            lkeys = _sort_key_for(left.table.columns[lcol], left.mask)
            rkeys = _sort_key_for(right.table.columns[rcol], right.mask)
        else:
            # composite keys: dense-rank the union of both sides' key
            # tuples into one synthetic int32 key, then merge as usual
            lkeys, rkeys = _union_dense_rank(left, right, node.on)

        if right.num_rows == 0:
            # empty build side: no outer row has a match.  The reference
            # indexes the empty sorted keys here and raises; the per-row
            # answer is that semi keeps no rows and anti keeps them all.
            hit = torch.zeros(lkeys.shape, dtype=torch.bool, device=self.device)
            ridx = torch.zeros(lkeys.shape, dtype=torch.int64, device=self.device)
        else:
            kt = torch.promote_types(lkeys.dtype, rkeys.dtype)
            perm = _stable_order(rkeys)
            sorted_keys = rkeys[perm].to(kt)
            probe = lkeys.to(kt)
            pos = torch.searchsorted(sorted_keys, probe)
            pos = pos.clamp(0, sorted_keys.shape[0] - 1)
            hit = (sorted_keys[pos] == probe) & (lkeys != _key_sentinel(lkeys))
            ridx = perm[pos]

        if node.kind == "semi":
            return MaskedTable(left.table, left.mask & hit)
        if node.kind == "anti":
            return MaskedTable(left.table, left.mask & ~hit)

        rgathered = right.table.gather(ridx, valid=hit)
        cols = dict(left.table.columns)
        shared = {rc for lc, rc in node.on if lc == rc}
        rkeycols = {rc for _, rc in node.on}
        for name, col in rgathered.columns.items():
            if name in shared:
                continue
            if name in cols and name not in rkeycols:
                raise ValueError(f"join column collision: {name}")
            cols[name] = col
        mask = left.mask & hit if node.kind == "inner" else left.mask
        return MaskedTable(Table(cols), mask)

    # -- apply -------------------------------------------------------------
    def _exec_apply(self, node: R.Apply, ctx, memo) -> MaskedTable:
        left = self._exec(node.left, ctx, memo)
        n = left.num_rows
        correlated = _plan_has_outer(node.right)

        if not correlated:
            right = self._exec(node.right, ctx, memo)
            if right.num_rows != 1:
                raise NotImplementedError("uncorrelated Apply with multi-row right")
            cols = dict(left.table.columns)
            rvalid = right.mask[0]
            for name, c in right.table.columns.items():
                data = c.data[0].expand((n,) + tuple(c.data.shape[1:]))
                valid = (c.validity()[0] & rvalid).expand(n)
                cols[name] = Column(data, valid, c.dictionary)
            return MaskedTable(Table(cols), left.mask)

        # Correlated right side rooted at ConstantScan (the algebrizer's
        # region derived-tables): evaluate its Computes directly against the
        # left columns — "apply removal" performed at execution time.
        if _is_scalar_region(node.right):
            return self._exec_region_apply(node, left, ctx, memo)

        raise _a31("correlated Apply over a general subplan")

    def _exec_region_apply(self, node, left: MaskedTable, ctx, memo) -> MaskedTable:
        """Vectorized evaluation of a single-row derived table (an algebrized
        region) against every left row at once: Outer(c) binds to the left
        column c, ColRef(c) binds to region-local computed columns."""
        n = left.num_rows
        chain: list[R.RelNode] = []
        cur = node.right
        while isinstance(cur, (R.Compute, R.Project)):
            chain.append(cur)
            cur = cur.child
        assert isinstance(cur, R.ConstantScan)

        pt = None
        if node.passthrough is not None:
            v = S.eval_scalar(node.passthrough, left.env(), self._ctx(n, ctx))
            b = v.broadcast(n)
            pt = b.data.to(torch.bool) & b.validity()

        outer = {**ctx.outer, **left.env()}
        env: dict[str, S.Value] = {}
        cctx = S.EvalContext(self, n, ctx.params, outer, ctx.vars, self.device)
        cctx.row_mask = left.mask
        for nd in reversed(chain):
            if isinstance(nd, R.Compute):
                for name, expr in nd.computed.items():
                    env[name] = S.eval_scalar(expr, env, cctx).broadcast(n)
            else:  # Project
                env = {new: env[old] for new, old in nd.cols.items()}

        cols = dict(left.table.columns)
        for name, v in env.items():
            b = v.broadcast(n)
            valid = b.validity()
            if pt is not None:  # pass-through rows keep NULL right side
                valid = valid & ~pt
            cols[name] = Column(b.data, valid, b.dictionary)
        return MaskedTable(Table(cols), left.mask)

    # -- group-by ----------------------------------------------------------
    def _exec_groupagg(self, node: R.GroupAgg, ctx, memo) -> MaskedTable:
        child = self._exec(node.child, ctx, memo)
        n = child.num_rows
        env = child.env()
        cctx = self._ctx(n, ctx)

        # Pre-evaluate aggregate input expressions (vectorized).
        agg_inputs: dict[str, S.Value] = {}
        for name, spec in node.aggs.items():
            if spec.expr is not None:
                agg_inputs[name] = S.eval_scalar(spec.expr, env, cctx).broadcast(n)
        if _batched(child.mask,
                    *(c.data for c in child.table.columns.values()),
                    *(v.data for v in agg_inputs.values())):
            # inside a correlated subquery's vmap: the segment sums add in
            # place into an unbatched buffer and relagg has no batch axis
            raise _a31("GroupAgg inside a correlated subquery")

        if n == 0:
            # zero-row child: pad to one all-invalid row so the reductions
            # below keep a nonzero extent; the pad row is masked out, so
            # every group slot comes back unoccupied (reference ``:418-441``)
            child = MaskedTable(
                Table({
                    c: Column(
                        torch.zeros((1,) + tuple(cc.data.shape[1:]),
                                    dtype=cc.data.dtype, device=self.device),
                        torch.zeros((1,), dtype=torch.bool, device=self.device),
                        cc.dictionary,
                    )
                    for c, cc in child.table.columns.items()
                }),
                torch.zeros((1,), dtype=torch.bool, device=self.device),
            )
            agg_inputs = {
                name: S.Value(
                    torch.zeros((1,) + tuple(v.data.shape[1:]),
                                dtype=v.data.dtype, device=self.device),
                    torch.zeros((1,), dtype=torch.bool, device=self.device),
                    v.dictionary,
                )
                for name, v in agg_inputs.items()
            }
            n = 1

        if not node.keys:
            # full-table aggregate -> single row
            cols = {}
            for name, spec in node.aggs.items():
                cols[name] = _full_agg(spec.fn, agg_inputs.get(name), child.mask)
            return MaskedTable(Table(cols), self._ones(1))

        # batch-mode path (paper §8.2.6): single dictionary/dense-int key and
        # sum/count aggregates -> the fused relagg kernel (no sort)
        if self.use_pallas_agg and len(node.keys) == 1:
            out = self._try_relagg(node, child, agg_inputs)
            if out is not None:
                return out

        # stats-driven dense-key path: key densely covers [lo, hi] ->
        # gid = key - lo segmenting, no sort
        if node.dense_range is not None and len(node.keys) == 1:
            out = self._dense_groupagg(node, child, agg_inputs)
            if out is not None:
                return out

        # sort-based grouping with static capacity
        cap = node.capacity or n
        order = torch.arange(n, device=self.device)
        for k in reversed(node.keys):
            keys = _sort_key_for(child.table.columns[k], child.mask)[order]
            order = order[_stable_order(keys)]
        order = order[_stable_order(~child.mask[order])]
        mask_o = child.mask[order]

        sorted_keys = [
            _sort_key_for(child.table.columns[k], child.mask)[order]
            for k in node.keys
        ]
        newgrp = _run_starts(sorted_keys, n, self.device) & mask_o
        gid = _cumsum_i32(newgrp) - 1
        gid = torch.where(mask_o, gid.clamp(0, cap - 1), cap)  # overflow slot

        num_groups = torch.where(mask_o, gid, -1).max() + 1
        occupied = torch.arange(cap, device=self.device) < num_groups

        cols: dict[str, Column] = {}
        for kname in node.keys:
            kc = child.table.columns[kname]
            kdata = kc.data[order]
            slot = _segment_extreme(kdata, gid, cap + 1, "amax")[:cap]
            cols[kname] = Column(slot, occupied, kc.dictionary)

        for name, spec in node.aggs.items():
            if spec.fn == "count_star":
                cnt = _segment_sum(mask_o.to(torch.float32), gid, cap + 1)[:cap]
                cols[name] = Column(cnt.to(torch.int32), occupied)
                continue
            v = agg_inputs[name]
            data = v.data[order]
            vvalid = v.validity()[order] & mask_o
            cols[name] = _grouped_column(spec.fn, data, vvalid, gid, cap, occupied)
        return MaskedTable(Table(cols), occupied)

    def _dense_groupagg(self, node: R.GroupAgg, child: MaskedTable, agg_inputs):
        """Sort-free grouped aggregation for a dense int key range
        [lo, hi]: gid = key - lo, segment ops sized to the range."""
        key = node.keys[0]
        kc = child.table.columns[key]
        if kc.data.is_floating_point() or kc.data.dtype == torch.bool:
            return None
        lo, hi = node.dense_range
        cap = hi - lo + 1
        gid = kc.data.to(torch.int32) - lo
        inside = (gid >= 0) & (gid < cap) & child.mask & kc.validity()
        gid = torch.where(inside, gid, cap)  # overflow slot

        cols: dict[str, Column] = {}
        cnt_rows = _segment_sum(inside.to(torch.float32), gid, cap + 1)[:cap]
        occupied = cnt_rows > 0
        cols[key] = Column(
            (torch.arange(cap, dtype=torch.int32, device=self.device) + lo
             ).to(kc.data.dtype),
            occupied,
            kc.dictionary,
        )
        for name, spec in node.aggs.items():
            if spec.fn == "count_star":
                cols[name] = Column(cnt_rows.to(torch.int32), occupied)
                continue
            v = agg_inputs[name]
            vvalid = v.validity() & inside
            cols[name] = _grouped_column(spec.fn, v.data, vvalid, gid, cap, occupied)
        return MaskedTable(Table(cols), occupied)

    def _try_relagg(self, node: R.GroupAgg, child: MaskedTable, agg_inputs):
        """Fused group-by via the relagg kernel.  Applicable when the key is
        dictionary-encoded (G = vocab size) or a capacity hint bounds a
        non-negative int key, and all aggs are sum/avg/count/count_star."""
        from repro_torch.kernels.relagg.ops import grouped_aggregate

        key = node.keys[0]
        kc = child.table.columns[key]
        if kc.dictionary is not None:
            G = len(kc.dictionary)
        elif (node.capacity is not None and not kc.data.is_floating_point()
              and kc.data.dtype != torch.bool):
            G = int(node.capacity)
        else:
            return None
        if not all(a.fn in ("sum", "avg", "count", "count_star")
                   for a in node.aggs.values()):
            return None

        n = child.num_rows
        mask = child.mask & kc.validity() & (kc.data >= 0) & (kc.data < G)
        cols_spec: list[tuple[str, str, int, int]] = []  # (name, fn, vi, ci)
        mats = []
        for name, spec in node.aggs.items():
            if spec.fn == "count_star":
                cols_spec.append((name, spec.fn, -1, -1))
                continue
            v = agg_inputs[name]
            vv = v.validity()
            mats.append(torch.where(vv, v.data.to(torch.float32), 0.0))
            vi = len(mats) - 1
            mats.append(vv.to(torch.float32))  # per-agg valid count
            cols_spec.append((name, spec.fn, vi, vi + 1))
        vals = (
            torch.stack(mats, dim=1)
            if mats
            else torch.zeros((n, 1), dtype=torch.float32, device=self.device)
        )
        sums, counts = grouped_aggregate(kc.data.to(torch.int32), mask, vals, G)
        occupied = counts > 0
        out_cols: dict[str, Column] = {
            key: Column(torch.arange(G, dtype=kc.data.dtype, device=self.device),
                        occupied, kc.dictionary)
        }
        for name, fn, vi, ci in cols_spec:
            if fn == "count_star":
                out_cols[name] = Column(counts.to(torch.int32), occupied)
            elif fn == "count":
                out_cols[name] = Column(sums[:, ci].to(torch.int32), occupied)
            elif fn == "sum":
                out_cols[name] = Column(sums[:, vi], occupied & (sums[:, ci] > 0))
            else:  # avg
                c = sums[:, ci]
                out_cols[name] = Column(
                    sums[:, vi] / torch.where(c == 0, 1.0, c),
                    occupied & (c > 0),
                )
        return MaskedTable(Table(out_cols), occupied)

    # -- loop scan (rewritten cursor loops, repro_torch.loops) --------------
    def _exec_loopscan(self, node: R.LoopScan, ctx, memo) -> MaskedTable:
        child = self._exec(node.child, ctx, memo)
        ictx = self._ctx(1, ctx)
        init = {
            name: _scalar_value(S.eval_scalar(e, {}, ictx))
            for name, e in node.carry.items()
        }
        if node.kind == "reduce":
            return self._loopscan_reduce(node, child, init, ctx)
        return self._loopscan_scan(node, child, init, ctx)

    def _loopscan_reduce(self, node, child, init, ctx) -> MaskedTable:
        """Commutative fold: masked sum/prod over the whole relation —
        no sequential dependence, fully vectorized."""
        n = child.num_rows
        env = child.env()
        cctx = self._ctx(n, ctx)
        cctx.row_mask = child.mask
        active = child.mask
        cols: dict[str, Column] = {}
        for name in node.outputs:
            mode, op, term, pred = node.reductions[name]
            iv = init[name]
            if mode == "last":
                # final fetch-variable value: the last active row's column
                # (or the loop-entry value when the cursor is empty)
                col = child.table.columns[op]
                if n == 0:
                    out = iv
                else:
                    has = torch.any(active)
                    flipped = torch.flip(active, (0,)).to(torch.uint8)
                    idx = (n - 1) - torch.argmax(flipped)
                    out = S.Value(
                        torch.where(has, _take(col.data, idx),
                                    iv.data.to(col.data.dtype)),
                        torch.where(has, _take(col.validity(), idx),
                                    iv.validity()),
                        col.dictionary,
                    )
            else:  # fold
                tv = S.eval_scalar(term, env, cctx).broadcast(max(n, 1))
                g = active
                if pred is not None:
                    pv = S.eval_scalar(pred, env, cctx).broadcast(max(n, 1))
                    g = g & pv.data.to(torch.bool) & pv.validity()
                # the loop-entry value widens to the term's type, as
                # ``jnp.result_type``; the fold sums in that type
                common = torch.promote_types(iv.data.dtype, tv.data.dtype)
                td = tv.data.to(common)
                # NULL is sticky: any accumulated NULL term poisons the
                # fold, matching per-row +/* NULL propagation
                valid = iv.validity() & ~torch.any(g & ~tv.validity())
                if n == 0:
                    out = iv
                elif op == "+":
                    out = S.Value(iv.data.to(common)
                                  + torch.where(g, td, 0).sum(dtype=common), valid)
                else:  # "*"
                    out = S.Value(iv.data.to(common)
                                  * torch.where(g, td, 1).prod(dtype=common), valid)
            cols[name] = _value_to_column(_scalar_value(out), 1)
        return MaskedTable(Table(cols), self._ones(1))

    def _loopscan_scan(self, node, child, init, ctx) -> MaskedTable:
        """Order-dependent fold: the reference's ``lax.scan`` over the
        relation's rows, as a host loop over them in order, evaluating the
        predicated step list on one row at a time.  Masked-out rows are
        skipped (their steps see ``__live`` false); ``__done`` makes BREAK
        and failed guards sticky.  Each carry is cast back to its
        loop-entry dtype after every row, as the scan's invariant carry
        structure forces.  The rows are never batched or reordered, and
        nothing is read back to the host: the loop's length is the
        relation's row count, a shape."""
        from repro_torch.loops.rewrite import DONE, LIVE

        dicts = {c: col.dictionary for c, col in child.table.columns.items()}
        col_arrays = {
            c: (col.data, col.validity())
            for c, col in child.table.columns.items()
        }
        carry = {name: (v.data, v.validity()) for name, v in init.items()}
        dtypes = {name: d.dtype for name, (d, _) in carry.items()}
        consts: dict = {}  # the step list's literals, made once
        for i in range(child.num_rows):
            vars_env = {name: S.Value(d, v) for name, (d, v) in carry.items()}
            vars_env[LIVE] = S.Value(child.mask[i] & ~carry[DONE][0])
            env = {
                c: S.Value(d[i], v[i], dicts[c])
                for c, (d, v) in col_arrays.items()
            }
            sctx = S.EvalContext(self, 1, ctx.params, ctx.outer, vars_env,
                                 self.device, consts)
            for name, expr in node.steps:
                vars_env[name] = S.eval_scalar(expr, env, sctx)
            carry = {}
            for name, dtype in dtypes.items():
                nv = _scalar_value(vars_env[name])
                carry[name] = (nv.data.to(dtype), nv.validity())
        cols = {
            name: Column(carry[name][0].reshape(1), carry[name][1].reshape(1))
            for name in node.outputs
        }
        return MaskedTable(Table(cols), self._ones(1))

    # -- scalar-subquery hooks (called from scalar.eval_scalar) -------------
    def eval_scalar_subquery(self, expr: S.ScalarSubquery, env, ctx) -> S.Value:
        if not _plan_has_outer(expr.plan):
            res = self.execute(expr.plan, params=ctx.params, outer=ctx.outer,
                               vars=ctx.vars)
            return _extract_scalar(res, expr.column)
        # correlated: vmap the whole subplan over the outer rows — one
        # batched execution, never a loop over them
        n = ctx.num_rows
        names = sorted(
            _plan_outer_refs(expr.plan) & set(env.keys() | ctx.outer.keys())
        )
        dicts = {}
        cols = {}
        for m in names:
            v = env.get(m, ctx.outer.get(m))
            b = v.broadcast(n)
            cols[m] = (b.data, b.validity())
            dicts[m] = v.dictionary

        captured: dict = {}
        sub = self._sub_executor()

        def one(scalars):
            outer = {m: S.Value(scalars[m][0], scalars[m][1], dicts[m]) for m in names}
            outer = {**ctx.outer, **outer}
            res = sub.execute(expr.plan, params=ctx.params, outer=outer, vars=ctx.vars)
            v = _extract_scalar(res, expr.column)
            captured["dict"] = v.dictionary  # host metadata
            return v.data, v.validity()

        data, valid = torch.func.vmap(one)(cols)
        return S.Value(data, valid, captured.get("dict"))

    def eval_exists(self, expr: S.Exists, env, ctx) -> S.Value:
        if _plan_has_outer(expr.plan):
            raise _a31("correlated EXISTS")
        res = self.execute(expr.plan, params=ctx.params, outer=ctx.outer, vars=ctx.vars)
        v = torch.any(res.mask)
        return S.Value(~v if expr.negated else v)

    def eval_udf_call(self, expr: S.UdfCall, env, ctx) -> S.Value:
        if self.udf_column_evaluator is None:
            raise RuntimeError(
                f"UDF {expr.name!r} not inlined and no iterative evaluator "
                "attached (enable froid)"
            )
        return self.udf_column_evaluator(expr, env, ctx)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _key_sentinel(keys: torch.Tensor):
    return _F32_MAX if keys.is_floating_point() else _I32_MAX


def _grouped_column(fn: str, data: torch.Tensor, vvalid: torch.Tensor,
                    gid: torch.Tensor, cap: int, occupied: torch.Tensor) -> Column:
    """One sum/avg/count/min/max aggregate over ``gid`` segments (overflow
    slot ``cap`` dropped) — the reference's sort and dense paths share it."""
    ones = vvalid.to(torch.float32)
    c = _segment_sum(ones, gid, cap + 1)[:cap]
    if fn in ("sum", "avg", "count"):
        s = _segment_sum(torch.where(vvalid, data.to(torch.float32), 0.0),
                         gid, cap + 1)[:cap]
        if fn == "sum":
            return Column(s, occupied & (c > 0))
        if fn == "count":
            return Column(c.to(torch.int32), occupied)
        return Column(s / torch.where(c == 0, 1.0, c), occupied & (c > 0))
    if fn in ("min", "max"):
        sent = float("inf") if fn == "min" else float("-inf")
        m = _segment_extreme(torch.where(vvalid, data.to(torch.float32), sent),
                             gid, cap + 1, "amin" if fn == "min" else "amax")[:cap]
        return Column(m, occupied & (c > 0))
    raise NotImplementedError(fn)


def _full_agg(fn: str, v: S.Value | None, mask: torch.Tensor) -> Column:
    ones = torch.ones((1,), dtype=torch.bool, device=mask.device)
    if fn == "count_star":
        return Column(mask.sum().to(torch.int32).reshape(1), ones)
    assert v is not None
    sel = mask & v.validity()
    data = v.data
    if fn == "count":
        return Column(sel.sum().to(torch.int32).reshape(1), ones)
    if fn == "sum":
        s = torch.where(sel, data.to(torch.float32), 0.0).sum()
        return Column(s.reshape(1), sel.any().reshape(1))
    if fn == "avg":
        s = torch.where(sel, data.to(torch.float32), 0.0).sum()
        c = sel.sum().to(torch.int32)
        return Column((s / torch.where(c == 0, 1, c)).reshape(1),
                      (c > 0).reshape(1))
    if fn == "min":
        m = torch.where(sel, data.to(torch.float32), float("inf")).min()
        return Column(m.reshape(1), sel.any().reshape(1))
    if fn == "max":
        m = torch.where(sel, data.to(torch.float32), float("-inf")).max()
        return Column(m.reshape(1), sel.any().reshape(1))
    raise NotImplementedError(fn)


def _extract_scalar(res: MaskedTable, column: str | None) -> S.Value:
    names = res.table.names()
    if column is None:
        if len(names) != 1:
            raise ValueError(f"scalar subquery must produce 1 column, got {names}")
        column = names[0]
    c = res.table.columns[column]
    found = torch.any(res.mask)
    idx = torch.argmax(res.mask.to(torch.uint8))
    return S.Value(_take(c.data, idx), _take(c.validity(), idx) & found,
                   c.dictionary)


def _plan_has_outer(plan: R.RelNode) -> bool:
    return len(_plan_outer_refs(plan)) > 0


def _plan_outer_refs(plan: R.RelNode) -> set[str]:
    out: set[str] = set()
    for node in R.walk_plan(plan):
        for e in node.exprs():
            out |= S.free_outer(e)
        if isinstance(node, R.Compute):
            for e in node.computed.values():
                out |= S.free_outer(e)
                for sub in S.walk(e):
                    if isinstance(sub, (S.ScalarSubquery, S.Exists)):
                        out |= _plan_outer_refs(sub.plan)
        for e in node.exprs():
            for sub in S.walk(e):
                if isinstance(sub, (S.ScalarSubquery, S.Exists)):
                    out |= _plan_outer_refs(sub.plan)
    return out


def _is_scalar_region(plan: R.RelNode) -> bool:
    """True if ``plan`` is Compute/Project-over-ConstantScan — i.e. a
    single-row derived table (an algebrized region)."""
    node = plan
    while isinstance(node, (R.Compute, R.Project)):
        node = node.child
    return isinstance(node, R.ConstantScan)
